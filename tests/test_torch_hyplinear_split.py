"""The precision design of the tensor-core gyro-linear kernel
(``hyperspace_torch/kernels/csrc/hyplinear.cu``), checked on the CPU.

The kernel takes the product x @ M on the tensor cores in TF32, which
keeps 10 mantissa bits.  Each operand is split into ``hi``, rounded to
TF32 as ``cvt.rna.tf32.f32`` rounds, and ``lo``, the remainder (the
tensor core reads its top 10 mantissa bits), and each 8-deep step of the
product accumulates ``lo·hi' + hi·lo' + hi·hi'`` in f32 (3×TF32).  The
closed-form epilogue (the Möbius rescale, ⊕ b, proj) then runs in f32 on
the row sums ‖x‖² (of the unsplit x), ‖Mx‖², ⟨Mx, b⟩ and max|Mx|.  Here
that arithmetic is emulated in torch and held against a float64
reference at the JAX package's tier for this kernel (rtol = atol = 2e-4).

The reference is the same closed form in float64 with the f32 tier's
clamps (EPS 1e-7, MIN_NORM 1e-12, artanh at 1 ± 3e-7, proj's margin
4e-3): ``hyp_linear_plain`` on float64 inputs takes float64's clamps
(proj's margin 1e-5), a different function for rows pinned at the
margin.  Where no clamp binds, both references are held.

A single TF32 product a pair misses the tier on rows that proj pins at
the margin (M scaled by 30, as the card checks do) and on the path's own
rows at 48 → 32, c = 0.5; elsewhere on the path's rows it comes within
0.3–0.85 of it.  So the kernel takes three; the split's largest error is
under 1/200 of the tier.
"""

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels.hyplinear import hyp_linear_plain

RTOL = ATOL = 2e-4
EPS, MIN_NORM, ARTANH_EPS, BALL_EPS = 1e-7, 1e-12, 3e-7, 4e-3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away
    from zero (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its 13 low mantissa
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def product(x: torch.Tensor, m: torch.Tensor, terms: int) -> torch.Tensor:
    """x @ m as the kernel takes it, 8-deep step by step, each step's
    products accumulated in f32: ``terms`` 3 is lo·hi + hi·lo + hi·hi,
    1 is hi·hi alone.  A product of two TF32 values is exact in f32, so
    f32 matmuls of the parts give the tensor core's products."""
    n, d = x.shape
    kp = -(-d // 8) * 8
    xp = torch.zeros((n, kp), dtype=torch.float32)
    mp = torch.zeros((kp, m.shape[1]), dtype=torch.float32)
    xp[:, :d], mp[:d] = x, m
    acc = torch.zeros((n, m.shape[1]), dtype=torch.float32)
    for k in range(0, kp, 8):
        a, b = xp[:, k:k + 8], mp[k:k + 8]
        ah, bh = tf32(a), tf32(b)
        al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
        ah, bh = tf32_trunc(ah), tf32_trunc(bh)
        if terms == 3:
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def closed_form(x, mx, b, c):
    """The kernel's epilogue in x's dtype: the row sums, s (M ⊗ x = s·Mx),
    α and β ((s·Mx) ⊕ b = α·Mx + β·b) and proj's scale q."""
    c = torch.tensor(c, dtype=x.dtype)
    x2 = torch.sum(x * x, -1, keepdim=True)
    mx2 = torch.sum(mx * mx, -1, keepdim=True)
    mb = torch.sum(mx * b, -1, keepdim=True)
    zero = torch.amax(mx.abs(), -1, keepdim=True) == 0
    b2 = torch.sum(b * b)
    sc = torch.clamp_min(torch.sqrt(c), MIN_NORM)
    xn = torch.clamp_min(torch.sqrt(x2), MIN_NORM)
    mn = torch.clamp_min(torch.sqrt(mx2), MIN_NORM)
    z = torch.clamp(sc * xn, -1 + ARTANH_EPS, 1 - ARTANH_EPS)
    art = 0.5 * (torch.log1p(z) - torch.log1p(-z))
    s = torch.tanh(torch.clamp(mn / xn * art, -20, 20)) / (mn * sc)
    s = torch.where(zero, 0.0, s)
    r2, rb = s * s * mx2, s * mb
    d = torch.clamp_min(1 + 2 * c * rb + c * c * r2 * b2, EPS)
    al = (1 + 2 * c * rb + c * b2) * s / d
    be = (1 - c * r2) / d
    zn = torch.clamp_min(torch.sqrt(al * al * mx2 + 2 * al * be * mb
                                    + be * be * b2), MIN_NORM)
    max_norm = (1 - BALL_EPS) / sc
    q = torch.where(zn > max_norm, max_norm / zn, 1.0)
    return (al * mx + be * b) * q


def emulated(x, m, b, c, terms):
    return closed_form(x, product(x, m, terms), b, c)


def reference(x, m, b, c):
    x, m, b = x.double(), m.double(), b.double()
    return closed_form(x, x @ m, b, c)


def ball_rows(rng, shape, c, scale=0.8):
    """Ball points at radii up to ``scale``/√c (``tests/test_torch_cuda.py``)."""
    v = rng.standard_normal(shape)
    v = v / (1.0 + np.linalg.norm(v, axis=-1, keepdims=True))
    return torch.as_tensor(v * scale / np.sqrt(c), dtype=torch.float32)


def case(d_in, d_out, c, kind, n=3000):
    """x, M, b of the layer path's kind: ``path`` (every 7th row 0),
    ``margin`` (M scaled by 30: rows pinned at proj's margin) or
    ``zero_m`` (M x = 0 on every row)."""
    rng = np.random.default_rng(1000 * d_in + d_out + int(10 * c))
    x = ball_rows(rng, (n, d_in), c)
    x[::7] = 0.0
    m = torch.as_tensor(rng.standard_normal((d_in, d_out)) / np.sqrt(d_in),
                        dtype=torch.float32)
    b = ball_rows(rng, (d_out,), c, 0.3)
    if kind == "margin":
        m = 30.0 * m
    elif kind == "zero_m":
        m = torch.zeros_like(m)
    return x, m, b


def misses(got, want):
    """Entries beyond the tier, and the largest error over its bound."""
    err = (got.double() - want.double()).abs()
    tol = ATOL + RTOL * want.double().abs()
    return int((err > tol).sum()), float((err / tol).max())


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      np.pi, -1e-3, 0.0], dtype=torch.float32)
    assert torch.equal(tf32(x)[:3], torch.tensor(
        [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]))
    hi, lo = tf32(x), tf32_trunc(x - tf32(x))
    assert torch.all((hi.double() + lo.double() - x.double()).abs()
                     <= 2.0 ** -21 * x.double().abs())


@pytest.mark.parametrize("kind", ["path", "margin", "zero_m"])
@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("d_in,d_out", [(48, 32), (128, 32), (128, 128)])
def test_three_term_split_meets_the_tier(d_in, d_out, c, kind):
    x, m, b = case(d_in, d_out, c, kind)
    got = emulated(x, m, b, c, 3)
    want = reference(x, m, b, c)
    bad, worst = misses(got, want)
    assert bad == 0 and worst < 5e-3, worst
    if kind != "margin":          # no clamp binds: the plain version too
        plain = hyp_linear_plain(x.double(), m.double(), b.double(), c)
        assert misses(got, plain)[0] == 0
    assert torch.equal(got[::7], b.expand_as(got[::7]))   # x = 0 → b
    if kind == "zero_m":
        assert torch.equal(got, b.expand_as(got))


@pytest.mark.parametrize("d_in,d_out,c,kind", [
    (48, 32, 1.0, "margin"), (48, 32, 0.5, "margin"), (128, 32, 1.0, "margin"),
    (128, 32, 0.5, "margin"), (48, 32, 0.5, "path")])
def test_one_tf32_product_misses_the_tier(d_in, d_out, c, kind):
    x, m, b = case(d_in, d_out, c, kind, n=6000)
    want = reference(x, m, b, c)
    bad, worst = misses(emulated(x, m, b, c, 1), want)
    assert bad > 0 and worst > 1.0
    assert misses(emulated(x, m, b, c, 3), want)[1] < 5e-3


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("d_in,d_out", [(48, 32), (128, 32), (128, 128)])
def test_one_tf32_product_leaves_no_margin_at_the_path_inputs(d_in, d_out,
                                                              c):
    """On the path's own rows one product a pair comes within a few times
    of the bound (where it does not cross it), the split's under 1/200 of
    it."""
    x, m, b = case(d_in, d_out, c, "path")
    want = reference(x, m, b, c)
    one, three = (misses(emulated(x, m, b, c, t), want)[1] for t in (1, 3))
    assert one > 0.25 and three < 5e-3
