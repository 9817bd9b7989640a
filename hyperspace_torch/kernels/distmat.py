"""All-pairs hyperbolic distance matrix (counterpart of
``hyperspace_tpu/kernels/distmat.py``).

``pdist`` launches the hand-written CUDA kernel ``csrc/pdist.cu`` for
tensors on a CUDA device and runs :func:`pdist_plain` — the same closed
forms in PyTorch — for tensors on the CPU:

- ball:        d(x,y) = (1/√c)·arcosh(1 + 2c‖x−y‖² / ((1−c‖x‖²)(1−c‖y‖²)))
  with ‖x−y‖² = ‖x‖² − 2⟨x,y⟩ + ‖y‖²;
- hyperboloid: d(x,y) = (1/√c)·arcosh(−c⟨x,y⟩_L) (time lane negated).

Two lanes: float32, and bfloat16 in and out (the bf16 serving lane),
which computes in float32 and rounds each distance once, as the TPU
kernel's body does.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.manifolds import smath

_KINDS = {"poincare": 0, "lorentz": 1}


def pdist_plain(x: torch.Tensor, y: torch.Tensor, c, *,
                manifold: str) -> torch.Tensor:
    """The closed forms in plain PyTorch.  float32 computes in float32
    (the epsilon guards follow the dtype, as the JAX twins do); bfloat16
    inputs compute in float32 and round the distances once to bfloat16,
    as the TPU kernel's body does."""
    if x.dtype == torch.bfloat16:
        return pdist_plain(x.float(), y.float(), c,
                           manifold=manifold).to(torch.bfloat16)
    cc = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    sc = smath.clamp_min(smath.sqrt_c(cc, x), smath.min_norm(x.dtype))
    if manifold == "lorentz":
        y_flip = torch.cat([-y[:, :1], y[:, 1:]], dim=1)
        u = smath.clamp_min(-cc * (x @ y_flip.T) - 1.0, 0.0)
        return smath.arcosh1p(u) / sc
    xx = smath.sq_norm(x)                 # [n, 1]
    yy = smath.sq_norm(y)[:, 0]           # [m]
    d2 = smath.clamp_min(xx - 2.0 * (x @ y.T) + yy[None, :], 0.0)
    den = smath.clamp_min((1.0 - cc * xx) * (1.0 - cc * yy[None, :]),
                          smath.eps_for(x.dtype))
    return smath.arcosh1p(2.0 * cc * d2 / den) / sc


_ENTRY = {torch.float32: "hs_pdist", torch.bfloat16: "hs_pdist_bf16"}
_LANE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _launch(x: torch.Tensor, y: torch.Tensor, c: float,
            kind: int) -> torch.Tensor:
    S.check_cuda("pdist", tuple(_ENTRY), x, y)
    if x.dtype != y.dtype:
        raise ValueError(f"pdist: x is {x.dtype}, y is {y.dtype}; want "
                         "one dtype")
    n, d = x.shape
    out = torch.empty((n, y.shape[0]), dtype=x.dtype, device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("pdist", _ENTRY[x.dtype],
                    [P, P, P, I, I, I, ctypes.c_float, I, P])
    S.check(fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, y.shape[0], d,
               float(c), kind, S.stream_ptr(x)), "pdist")
    pdist.launches += 1
    pdist.launches_by_lane[_LANE[x.dtype]] += 1
    return out


def pdist(x: torch.Tensor, y: torch.Tensor, c, *,
          manifold: str) -> torch.Tensor:
    """All-pairs distance matrix ``d[i, j] = dist(x[i], y[j])``.

    ``x: [n, d]``, ``y: [m, d]`` (Lorentz rows carry the time coordinate
    in lane 0), ``c`` the positive curvature magnitude (a float),
    ``manifold`` one of ``"poincare"`` / ``"lorentz"``.  CUDA tensors
    (float32 or bfloat16, one dtype, contiguous) go through the CUDA
    kernel and give the inputs' dtype; CPU tensors go through
    :func:`pdist_plain`."""
    if manifold not in _KINDS:
        raise ValueError(f"pdist: unknown manifold {manifold!r} "
                         f"(want one of {sorted(_KINDS)})")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pdist: want [n, d] x [m, d]; got "
                         f"{tuple(x.shape)} x {tuple(y.shape)}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return pdist_plain(x, y, c, manifold=manifold)
    if x.device.type != "cuda":
        raise ValueError(f"pdist: unsupported device {x.device}")
    return _launch(x, y, float(c), _KINDS[manifold])


pdist.launches = 0
# launches of each lane: the smoke's lane runs read and reset them with
# ``launches``
pdist.launches_by_lane = dict.fromkeys(_LANE.values(), 0)
