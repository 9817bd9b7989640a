"""The order of evaluation of the all-pairs distance kernel
(``hyperspace_torch/kernels/csrc/pdist.cu``), checked on the CPU.

The kernel takes each Gram ⟨x, y⟩ and the squared norms ‖x‖², ‖y‖² as
sequential f32 FMAs over k in the same order (so a ball row against its
own copy gives d2 = 0 exactly), hoists the row factors fx = 1 − c‖x‖²
and 2c/fx and the column factors fy = 1 − c‖y‖² and 1/fy out of the
output loop, takes u = d2·(2c/fx)·(1/fy) where fx·fy ≥ 1e-7 and
d2·(2c/1e-7) where the clamp binds (rows outside the ball, where a factor
is ≤ 0), and multiplies ln(1 + u + √(u(u+2))) by 1/√c.  Here that
arithmetic is emulated in torch f32 (an FMA as the float64 result rounded
once to f32) and held against

- ``pdist_plain`` at the kernels' tier, rtol 1e-5 / atol 1e-4, on every
  pair that is not a duplicate: at d = 0 the plain version's Gram
  (another summation order than its norms) leaves rounding noise that
  the square root of the closed form lifts above atol, while the
  kernel's order gives 0 exactly on the ball;
- a float64 twin of the closed forms (the f32 tier's clamps) on the same
  f32 inputs, within the f32 Gram form's own error bound: the error of
  an f32 dot product of D terms, carried through the closed form, plus
  the tier.  ``pdist_plain`` is held to the same bound.

The hazards: duplicates (d = 0), rows at ‖x‖ = (1 − 4e-3)/√c, unprojected
rows with 1 − c‖x‖² ≤ 0, hyperboloid rows at D = 11, c = 1 and 0.5, and
D = 1, 3, 10 and 40.  The card's log2 and rsqrt approximations are held
by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels.distmat import pdist_plain
from hyperspace_torch.manifolds.maps import ball_to_lorentz

RTOL, ATOL = 1e-5, 1e-4
U = 2.0 ** -24
HAZARDS = ("random", "duplicates", "edge", "outside")


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def fma(a, b, c):
    """fmaf: a·b + c rounded once (the float64 sum rounded to f32)."""
    return f32(a.double() * b.double() + c.double())


def seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, D] · [m, D] → [n, m] as sequential FMAs over k from 0."""
    g = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    for k in range(a.shape[1]):
        g = fma(a[:, k:k + 1], b[None, :, k], g)
    return g


def kernel_form(x: torch.Tensor, y: torch.Tensor, c: float,
                manifold: str) -> torch.Tensor:
    """The kernel's arithmetic in f32 (c a Python float, rounded to f32
    as the launcher takes it)."""
    cf = torch.tensor(c, dtype=torch.float32)
    c64 = cf.double()
    ln2_sc = f32(torch.tensor(np.log(2.0))) / torch.clamp_min(torch.sqrt(cf),
                                                             1e-12)
    if manifold == "lorentz":
        xs = torch.cat([-x[:, :1], x[:, 1:]], dim=1)
        g = seq_dot(xs, y)
        u = f32(-c64 * g.double() - 1.0)
    else:
        g = seq_dot(x, y)
        xx = torch.diagonal(seq_dot(x, x))[:, None]
        yy = torch.diagonal(seq_dot(y, y))[None, :]
        fx = f32(1.0 - c64 * xx.double())
        fy = f32(1.0 - c64 * yy.double())
        px = (2.0 * cf) / fx
        ry = 1.0 / fy
        c2e7 = (2.0 * cf) / torch.tensor(1e-7, dtype=torch.float32)
        d2 = torch.clamp_min(f32(xx.double() - 2.0 * g.double()) + yy, 0.0)
        u = torch.where(fx * fy >= torch.tensor(1e-7, dtype=torch.float32),
                        (d2 * px) * ry, d2 * c2e7)
    u = torch.clamp_min(u, 0.0)
    v = u * (u + 2.0)
    w = 1.0 + (u + torch.sqrt(v))
    return torch.log2(w) * ln2_sc


def twin64(x, y, c, manifold):
    """The closed forms in float64 with the f32 tier's clamps."""
    x, y = x.double(), y.double()
    sc = max(np.sqrt(c), 1e-12)
    if manifold == "lorentz":
        yf = torch.cat([-y[:, :1], y[:, 1:]], dim=1)
        u = torch.clamp_min(-c * (x @ yf.T) - 1.0, 0.0)
    else:
        xx = torch.sum(x * x, 1, keepdim=True)
        yy = torch.sum(y * y, 1)[None, :]
        d2 = torch.clamp_min(xx - 2.0 * (x @ y.T) + yy, 0.0)
        den = torch.clamp_min((1.0 - c * xx) * (1.0 - c * yy), 1e-7)
        u = 2.0 * c * d2 / den
    return torch.log1p(u + torch.sqrt(u * (u + 2.0))) / sc


def arcosh1p(u):
    return torch.log1p(u + torch.sqrt(u * (u + 2.0)))


def gram_bound(x, y, c, manifold):
    """How far an f32 evaluation of the closed form may sit from the
    float64 twin: each f32 dot of D terms (and the combinations after
    it) off by γ = (D + 4)·2^-24 of its terms' absolute sum, the factors
    off by a few ulp, carried through arcosh(1 + u)/√c."""
    x, y = x.double(), y.double()
    d = x.shape[1]
    gam = (d + 4) * U
    sc = max(np.sqrt(c), 1e-12)
    ax = x.abs() @ y.abs().T
    if manifold == "lorentz":
        yf = torch.cat([-y[:, :1], y[:, 1:]], dim=1)
        u = torch.clamp_min(-c * (x @ yf.T) - 1.0, 0.0)
        du = c * gam * ax + 4 * U * (1.0 + u)
    else:
        xx = torch.sum(x * x, 1, keepdim=True)
        yy = torch.sum(y * y, 1)[None, :]
        fx, fy = 1.0 - c * xx, 1.0 - c * yy
        den = torch.clamp_min(fx * fy, 1e-7)
        d2 = torch.clamp_min(xx - 2.0 * (x @ y.T) + yy, 0.0)
        u = 2.0 * c * d2 / den
        dd2 = gam * (xx + 2.0 * ax + yy)
        rel = 8 * U * (1.0 + c * xx / fx.abs()) * (1.0 + c * yy / fy.abs())
        du = 2.0 * c * dd2 / den + rel * u
    hi = arcosh1p(u + du)
    lo = arcosh1p(torch.clamp_min(u - du, 0.0))
    return (hi - lo) / sc


def ball(rng, n, d, c, lo=0.0, hi=0.9):
    """Ball rows at radii uniform in [lo, hi]/√c."""
    v = rng.standard_normal((n, d))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rng.uniform(lo, hi, (n, 1)) / np.sqrt(c)
    return torch.as_tensor(v * r, dtype=torch.float32)


def case(hazard, d, c, manifold):
    rng = np.random.default_rng(1000 * d + 10 * int(10 * c)
                                + HAZARDS.index(hazard))
    dd = d - 1 if manifold == "lorentz" else d
    x, y = ball(rng, 40, dd, c), ball(rng, 300, dd, c)
    if hazard == "duplicates":
        y[::7][:40] = x[: len(y[::7][:40])]
    elif hazard == "edge":
        x[::2] = x[::2] / torch.linalg.norm(x[::2], dim=1, keepdim=True) * (
            (1 - 4e-3) / np.sqrt(c))
        y[::3] = y[::3] / torch.linalg.norm(y[::3], dim=1, keepdim=True) * (
            (1 - 4e-3) / np.sqrt(c))
    elif hazard == "outside":
        x[::3] = ball(rng, len(x[::3]), dd, c, 1.0, 1.3)
        y[::4] = ball(rng, len(y[::4]), dd, c, 1.0, 1.3)
    if manifold == "lorentz":
        x, y = (ball_to_lorentz(t, c).contiguous() for t in (x, y))
    dup = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.bool)
    if hazard == "duplicates":
        dup = torch.all(x[:, None, :] == y[None, :, :], dim=-1)
    return x, y, dup


CASES = ([("poincare", d, c, h) for d in (1, 3, 10, 40) for c in (1.0, 0.5)
          for h in HAZARDS]
         + [("lorentz", d, c, h) for d in (3, 11) for c in (1.0, 0.5)
            for h in ("random", "duplicates")])


@pytest.mark.parametrize("manifold,d,c,hazard", CASES)
def test_kernel_form_matches_the_plain_version(manifold, d, c, hazard):
    x, y, dup = case(hazard, d, c, manifold)
    got = kernel_form(x, y, c, manifold)
    want = pdist_plain(x, y, c, manifold=manifold)
    assert bool(torch.isfinite(got).all())
    bad = ((got - want).abs() > ATOL + RTOL * want.abs()) & ~dup
    assert int(bad.sum()) == 0


@pytest.mark.parametrize("manifold,d,c,hazard", CASES)
def test_kernel_form_within_the_gram_bound_of_float64(manifold, d, c,
                                                      hazard):
    x, y, _ = case(hazard, d, c, manifold)
    want = twin64(x, y, c, manifold)
    tol = gram_bound(x, y, c, manifold) + ATOL + RTOL * want.abs()
    for got in (kernel_form(x, y, c, manifold),
                pdist_plain(x, y, c, manifold=manifold)):
        assert bool(((got.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("c", [1.0, 0.5])
@pytest.mark.parametrize("d", [1, 3, 10, 40])
def test_ball_duplicates_give_zero(d, c):
    """‖x‖², ‖y‖² and ⟨x, y⟩ in one order: d2 = xx − 2·xx + xx = 0."""
    x, y, dup = case("duplicates", d, c, "poincare")
    assert bool(dup.any())
    assert bool((kernel_form(x, y, c, "poincare")[dup] == 0).all())


def test_the_clamp_binds_on_rows_outside_the_ball():
    """An unprojected row (1 − c‖x‖² ≤ 0) against one inside takes
    2c·d2/1e-7, as the plain version does; two rows outside take the
    product of the two (negative) factors."""
    x = torch.tensor([[1.1, 0.0, 0.0], [0.0, 1.2, 0.0]])
    y = torch.tensor([[0.3, 0.1, 0.0], [0.0, -1.05, 0.0]])
    got = kernel_form(x, y, 1.0, "poincare")
    want = pdist_plain(x, y, 1.0, manifold="poincare")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    fx = 1.0 - (x * x).sum(1, keepdim=True)
    fy = 1.0 - (y * y).sum(1)[None, :]
    assert bool(((fx * fy < 1e-7) == torch.tensor(
        [[True, False], [True, False]])).all())
