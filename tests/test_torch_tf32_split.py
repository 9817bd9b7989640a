"""The precision design of the tensor-core flash-attention forward
(``hyperspace_torch/kernels/csrc/attention.cu``), checked on the CPU.

The kernel forms the Gram Q·(JK)ᵀ and the average P·V with TF32 tensor
core products.  TF32 keeps 10 mantissa bits, so each operand x is split
into ``hi``, x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to
nearest, ties away from zero), and ``lo``, the exact remainder x − hi
truncated to TF32, and each product is taken as ``lo·hi' + hi·lo' +
hi·hi'`` with f32 accumulation (3×TF32).  Here that
arithmetic is emulated in torch on HyboNet-like Lorentz rows (the
chip smoke's ``hb_inputs``: spatial parts of std 0.5, and wider radii up
to 3) and held against a float64 reference with the kernel's own
tolerances (out rtol 1e-4 / atol 1e-5, lse 1e-5·(1 + |lse|)).  A single
TF32 product per pair is shown to miss them.

The backward kernels take their products the same way: the Grams again,
dsp·Vᵀ and dσ·K (dq), Pᵀ·dsp, V·dspᵀ and dσᵀ·Q (dk/dv), with P and dσ
split into hi and lo before they are multiplied.  dq, dk and dv are held
against float64 at the kernels' tolerance (largest error over the
largest entry below 1e-4, as ``tests/test_torch_cuda.py`` holds the
kernels against their plain versions), and a single TF32 product is
shown to miss it.
"""

import numpy as np
import pytest
import torch

OUT_RTOL, OUT_ATOL = 1e-4, 1e-5
LSE_TOL = 1e-5
GRAD_TOL = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away
    from zero (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 with its 13 low mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split: (hi, lo) with x − hi − lo below 2^-21·|x|."""
    hi = tf32(x)
    return hi, tf32_trunc(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b in f32 from TF32 operands: ``terms`` 1 is one TF32 product,
    3 the split ``lo·hi + hi·lo + hi·hi`` (small terms first).  Products
    of two TF32 values are exact in f32, so f32 matmuls of the parts
    give the tensor core's products with f32 accumulation."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def lorentz_rows(rng, b, n, d, radius):
    """[b, n, d] hyperboloid rows (c = 1): spatial parts of std 0.5 as
    ``hb_inputs`` makes them, or at hyperbolic radii uniform in
    [0, radius]."""
    u = rng.standard_normal((b, n, d - 1))
    if radius is None:
        sp = u * 0.5
    else:
        r = rng.uniform(0.0, radius, (b, n, 1))
        sp = np.sinh(r) * u / np.linalg.norm(u, axis=-1, keepdims=True)
    t = np.sqrt(1.0 + np.sum(sp * sp, axis=-1, keepdims=True))
    return np.concatenate([t, sp], axis=-1)


def forward(q, k, v, beta, tau, valid, gram_fn, pv_fn):
    """The forward kernel's arithmetic (``flash_fwd_plain``, c = 1) with
    the two products supplied: (out, lse)."""
    jk = torch.cat([-k[..., :1], k[..., 1:]], dim=-1)
    sigma = (2.0 + 2.0 * gram_fn(q, jk.transpose(-1, -2)) + beta) / tau
    logits = torch.where(valid, sigma, -1e30)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    s = pv_fn(p, v) / l
    sp = (torch.sum(s[..., 1:] * s[..., 1:], dim=-1, keepdim=True)
          - s[..., :1] * s[..., :1])
    out = s / torch.sqrt(torch.clamp_min(-sp, 1e-7))
    return out, (m + torch.log(l))[..., 0]


def case(d, radius, seed=0, b=4, n=128):
    rng = np.random.default_rng(seed + 97 * d + int(10 * (radius or 0)))
    q, k, v = (lorentz_rows(rng, b, n, d, radius) for _ in range(3))
    lens = rng.integers(n // 2, n + 1, b)
    m = np.arange(n)[None, :] < lens[:, None]
    valid = m[:, None, :] & m[:, :, None]
    valid[:, :, 0] = True                  # no row without a valid key
    beta = rng.standard_normal((b, 1, 1)) * 0.3
    tau = 1.0 + rng.random((b, 1, 1))
    f64 = [torch.as_tensor(x, dtype=torch.float64) for x in (q, k, v)]
    return f64, torch.as_tensor(valid), torch.as_tensor(beta), \
        torch.as_tensor(tau)


def misses(d, radius, terms):
    """Entries of out and lse beyond the kernel's tolerances when both
    products take ``terms`` TF32 products, against float64."""
    (q, k, v), valid, beta, tau = case(d, radius)
    want_out, want_lse = forward(q, k, v, beta, tau, valid,
                                 torch.matmul, torch.matmul)

    def emulated(a, b_):
        return product(a, b_, terms)

    f = [t.float() for t in (q, k, v)]
    got_out, got_lse = forward(*f, beta.float(), tau.float(), valid,
                               emulated, emulated)
    out_bad = (got_out.double() - want_out).abs() > (
        OUT_ATOL + OUT_RTOL * want_out.abs())
    lse_bad = (got_lse.double() - want_lse).abs() > (
        LSE_TOL * (1.0 + want_lse.abs()))
    return int(out_bad.sum()), int(lse_bad.sum())


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 1.5,
                      -3.0 - 2.0 ** -10, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0, 1.5,
                         -3.0 - 2.0 ** -9, 0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    x = torch.tensor([np.pi, -1e-3, 7.0 / 3.0], dtype=torch.float32)
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32_trunc(lo), lo)
    assert not torch.equal(hi, x)
    assert torch.all((hi.double() + lo.double() - x.double()).abs()
                     <= 2.0 ** -21 * x.double().abs())


@pytest.mark.parametrize("radius", [None, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("d", [9, 17, 33, 72])
def test_three_term_split_meets_the_kernel_tolerances(d, radius):
    assert misses(d, radius, 3) == (0, 0)


@pytest.mark.parametrize("radius", [None, 3.0])
@pytest.mark.parametrize("d", [9, 33, 72])
def test_one_tf32_product_misses_them(d, radius):
    out_bad, lse_bad = misses(d, radius, 1)
    assert out_bad + lse_bad > 0


def flip(x: torch.Tensor) -> torch.Tensor:
    """J x: lane 0 negated."""
    return torch.cat([-x[..., :1], x[..., 1:]], dim=-1)


def backward(q, k, v, dsp, beta, tau, valid, lse, di, prod):
    """The backward kernels' arithmetic (``flash_dq_plain`` and
    ``flash_dkv_plain``, c = 1) as the kernels order it, with every
    product supplied: (dq, dk, dv).  J and 2/τ are applied after the
    sums, as the kernels apply them at the store, and dP − di is taken
    about the first value row, as the kernels take it."""
    t = (lambda x: x.transpose(-1, -2))
    m = v[:, :1, :]                  # dP − di = ⟨dsp, v − m⟩ − (di − ⟨dsp, m⟩)
    dic = di - torch.sum(dsp * m, dim=-1)
    sigma = (2.0 + 2.0 * prod(q, t(flip(k))) + beta) / tau
    p = torch.where(valid, torch.exp(sigma - lse[..., None]), 0.0)
    dsig = p * (prod(dsp, t(v - m)) - dic[..., None])
    dq = (2.0 / tau) * flip(prod(dsig, k))
    sigma_t = (2.0 + 2.0 * prod(flip(k), t(q)) + beta) / tau
    p_t = torch.where(t(valid), torch.exp(sigma_t - lse[:, None, :]), 0.0)
    dv = prod(p_t, dsp)
    dsig_t = p_t * (prod(v - m, t(dsp)) - dic[:, None, :])
    dk = (2.0 / tau) * flip(prod(dsig_t, q))
    return dq, dk, dv


def backward_case(d, radius):
    """``case``'s rows with a cotangent dsp of the pre-normalisation
    average s, and lse and di = Σ dsp·s from the float64 forward."""
    (q, k, v), valid, beta, tau = case(d, radius)
    rng = np.random.default_rng(7 + 97 * d + int(10 * (radius or 0)))
    dsp = torch.as_tensor(rng.standard_normal(tuple(q.shape)))
    sigma = (2.0 + 2.0 * q @ flip(k).transpose(-1, -2) + beta) / tau
    logits = torch.where(valid, sigma, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)
    s = torch.exp(logits - lse[..., None]) @ v
    di = torch.sum(dsp * s, dim=-1)
    return q, k, v, dsp, beta, tau, valid, lse, di


def backward_errors(d, radius, terms):
    """Largest error over the largest entry of dq, dk and dv when every
    product takes ``terms`` TF32 products (f32 inputs), against float64."""
    args = backward_case(d, radius)
    want = backward(*args, torch.matmul)
    f32 = [a.float() if a.is_floating_point() else a for a in args]

    def emulated(a, b_):
        return product(a, b_, terms)

    got = backward(*f32, emulated)
    return [float((g.double() - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-3)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("radius", [None, 1.0, 2.0, 3.0])
@pytest.mark.parametrize("d", [9, 17, 33, 72])
def test_backward_three_term_split_meets_the_kernel_tolerance(d, radius):
    assert max(backward_errors(d, radius, 3)) < GRAD_TOL


@pytest.mark.parametrize("radius", [None, 3.0])
@pytest.mark.parametrize("d", [9, 33, 72])
def test_backward_one_tf32_product_misses_it(d, radius):
    assert max(backward_errors(d, radius, 1)) > GRAD_TOL
