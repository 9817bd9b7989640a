"""Fused hyperbolic-MLR logits (counterpart of
``hyperspace_tpu/kernels/mlr.py``, kernel N6; Ganea et al. 2018 eq. 25).

    logit_k(x) = (λ_{p_k}‖a_k‖/√c) · asinh( 2√c⟨z,a⟩ / ((1−c‖z‖²)‖a_k‖) ),
    z = (−p_k) ⊕_c x ,

with the Möbius addition expanded into rank-2 expressions of the inner
products ⟨x,p⟩, ⟨x,a⟩, ‖x‖², ‖p‖², ⟨p,a⟩ and ‖a‖², so the [N, K, d]
intermediate of the naive form (``nn.mlr.hyp_mlr_logits``) never exists.

:func:`hyp_mlr` launches ``csrc/mlr.cu`` for CUDA tensors (f32) and runs
:func:`hyp_mlr_plain` (the XLA twin ``_t_hyp_mlr``) for CPU tensors.  Its
gradient is the VJP of the plain version recomputed in the backward, as
``_mlr_bwd`` does: the JAX package has no backward kernel either.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.manifolds import smath


def hyp_mlr_plain(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                  c) -> torch.Tensor:
    """The expansion in plain PyTorch: x [..., d] ball points, p [K, d]
    hyperplane points, a [K, d] normals; returns [..., K]."""
    cc = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    mn, eps = smath.min_norm(x.dtype), smath.eps_for(x.dtype)
    sc = smath.clamp_min(smath.safe_sqrt(cc), mn)
    x2 = smath.sq_norm(x)                                    # [..., 1]
    p2 = smath.sq_norm(p)[:, 0]                              # [K]
    pa = torch.sum(p * a, dim=-1)                            # [K]
    a_norm = smath.clamp_min(smath.safe_norm(a, keepdim=False), mn)
    xp = torch.matmul(x, p.T)                                # [..., K]
    xa = torch.matmul(x, a.T)
    alpha = 1.0 - 2.0 * cc * xp + cc * x2
    beta = 1.0 - cc * p2
    den = smath.clamp_min(1.0 - 2.0 * cc * xp + (cc ** 2) * p2 * x2, eps)
    za = (-alpha * pa + beta * xa) / den
    z2 = (alpha ** 2 * p2 - 2.0 * alpha * beta * xp + beta ** 2 * x2) / (
        den ** 2)
    lam_p = 2.0 / smath.clamp_min(1.0 - cc * p2, eps)
    arg = 2.0 * sc * za / (smath.clamp_min(1.0 - cc * z2, eps) * a_norm)
    return (lam_p * a_norm / sc) * torch.asinh(arg)


def _launch(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
            c: float) -> torch.Tensor:
    S.check_cuda("hyp_mlr", (torch.float32,), x, p, a)
    n, d = x.shape
    k = p.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = S.function("mlr", "hs_hyp_mlr", [P, P, P, P, I, I, I,
                                          ctypes.c_float, P])
    S.check(fn(x.data_ptr(), p.data_ptr(), a.data_ptr(), out.data_ptr(), n,
               k, d, c, S.stream_ptr(x)), "hyp_mlr")
    hyp_mlr.launches += 1
    return out


def _forward(x2d, p, a, c):
    devs = {x2d.device, p.device, a.device}
    if devs == {torch.device("cpu")}:
        return hyp_mlr_plain(x2d, p, a, c)
    if any(dv.type != "cuda" for dv in devs):
        raise ValueError(f"hyp_mlr: unsupported device "
                         f"{sorted(map(str, devs))}")
    return _launch(x2d, p, a, float(c))


class _HypMLR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, p, a, c):
        ctx.save_for_backward(x2d, p, a)
        ctx.c = c
        return _forward(x2d, p, a, c)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = hyp_mlr_plain(*ins, ctx.c)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None)


def hyp_mlr(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
            c: float) -> torch.Tensor:
    """Hyperbolic-MLR logits [..., K] for ball points x [..., d],
    hyperplane points p [K, d] and normals a [K, d] at curvature c (a
    number); see the module docstring."""
    if p.ndim != 2 or a.shape != p.shape or x.shape[-1] != p.shape[1]:
        raise ValueError(f"hyp_mlr: want x [..., d], p and a [K, d]; got "
                         f"{tuple(x.shape)}, {tuple(p.shape)}, "
                         f"{tuple(a.shape)}")
    lead = x.shape[:-1]
    out = _HypMLR.apply(x.reshape(-1, x.shape[-1]).contiguous(),
                        p.contiguous(), a.contiguous(), c)
    return out.reshape(lead + out.shape[-1:])


hyp_mlr.launches = 0
