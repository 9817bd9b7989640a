"""Fused hyperbolic-MLR logits (counterpart of
``hyperspace_tpu/kernels/mlr.py``, kernel N6; Ganea et al. 2018 eq. 25).

    logit_k(x) = (λ_{p_k}‖a_k‖/√c) · asinh( 2√c⟨z,a⟩ / ((1−c‖z‖²)‖a_k‖) ),
    z = (−p_k) ⊕_c x ,

with the Möbius addition expanded into rank-2 expressions of the inner
products ⟨x,p⟩, ⟨x,a⟩, ‖x‖², ‖p‖², ⟨p,a⟩ and ‖a‖², so the [N, K, d]
intermediate of the naive form (``nn.mlr.hyp_mlr_logits``) never exists.

:func:`hyp_mlr` launches ``csrc/mlr.cu`` for CUDA tensors (f32) and runs
:func:`hyp_mlr_plain` (the XLA twin ``_t_hyp_mlr``) for CPU tensors.  The
launch follows :func:`mlr_plan`: a warp a logit for a few thousand logits
(HyboNet's heads), else row tiles on the tensor cores with a block's
classes staged once (HGCN node classification's [169,343, 40, 32]), and
a warp a logit again for rows too wide for the tiles' shared memory.  Its
gradient is the VJP of the plain version recomputed in the backward, as
``_mlr_bwd`` does (the JAX package has no backward kernel either), with
respect to the curvature too when ``c`` is a tensor that needs one (a
learned curvature).  The kernel reads ``c`` from device memory: a 0-d
tensor on x's device as it is, a number from a device scalar made once
per (device, value), so a step never reads the curvature on the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.manifolds import smath


def hyp_mlr_plain(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                  c) -> torch.Tensor:
    """The expansion in plain PyTorch: x [..., d] ball points, p [K, d]
    hyperplane points, a [K, d] normals; returns [..., K]."""
    cc = smath.as_scalar(c, x)          # a fill: a graph can capture it
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


# csrc/mlr.cu's block: 8 warps, each a 16-row tile (or a share of one).
# The plan models the block's shared memory to choose the class chunk;
# the kernel sizes it itself and refuses a block the card cannot hold.
WARPS, TILE_ROWS, SLICE = 8, 16, 16
MAX_CHUNK = 64                 # classes a block stages: 8 n-tiles of 8
NCONST = 8                     # per-class constants in shared memory
SMEM_CAP = 232_448             # the H100's dynamic shared memory a block
# a tile's depth is split across warps while the row tiles give the card
# fewer warps than this (132 SMs × 8)
SPLIT_BELOW_WARPS = 1056
# launches of at most PAIR_LOGITS + PAIR_LOGITS_PER_CLASS·kc logits take
# the pair kernel, a warp a (row, class) with no block barrier: its time
# grows with the logits while a few row tiles cost the tile kernel a
# floor that grows with its chunk of kc classes (HyboNet's heads and the
# measured crossings, PERF.md §6)
PAIR_LOGITS, PAIR_LOGITS_PER_CLASS = 4096, 256


class MlrPlan(NamedTuple):
    """A launch of ``csrc/mlr.cu``.  ``tile`` False: the pair kernel, a
    warp a (row, class), and the other fields 0.  Else the tile kernel:
    ``kc`` classes a block (a multiple of 8), ``chunks`` = ⌈k/kc⌉ blocks
    along the classes (and ⌈n/16⌉ tiles in groups of 8/splits along the
    rows), ``splits`` warps sharing a 16-row tile's 16-wide k slices, and
    ``smem`` bytes of dynamic shared memory (:func:`mlr_smem`)."""
    tile: bool
    kc: int
    chunks: int
    splits: int
    smem: int


def mlr_pitch(d: int) -> int:
    """Words a staged class row takes: d rounded up to 16-wide slices,
    16 mod 32 (conflict-free 16-byte fragment loads)."""
    slices = max(1, -(-d // SLICE))
    return SLICE * slices + (SLICE if slices % 2 == 0 else 0)


def mlr_smem(kc: int, splits: int, d: int) -> int:
    """Bytes of shared memory of a block, as ``hs_hyp_mlr_smem`` gives
    them: p and a staged [kc, pitch] as TF32 hi and lo parts, the class
    constants, and each warp's region (its tile's [16, kc] logits, or its
    partial fragments where the depth is split)."""
    region = 32 * (kc + 2) if splits > 1 else TILE_ROWS * kc
    return 4 * (4 * kc * mlr_pitch(d) + NCONST * kc + WARPS * region)


PAIR = MlrPlan(False, 0, 0, 0, 0)


def tile_plan(n: int, k: int, d: int) -> MlrPlan | None:
    """The tile kernel's plan for x [n, d] and k classes: the widest
    class chunk (at most 64, balanced over the chunks) whose block fits
    in shared memory, and the depth split across up to 8 warps where the
    row tiles are too few to fill the card; None for rows too wide for
    any chunk (d above about 1,700)."""
    slices = max(1, -(-d // SLICE))
    tiles = -(-n // TILE_ROWS)
    want = 1
    while (2 * want <= min(WARPS, slices)
           and 2 * want * tiles * -(-k // MAX_CHUNK) <= SPLIT_BELOW_WARPS):
        want *= 2
    for splits in dict.fromkeys((want, 1)):
        for nt in range(min(MAX_CHUNK, -(-k // 8) * 8) // 8, 0, -1):
            chunks = -(-k // (8 * nt))
            per = -(-k // chunks)
            kc = -(-per // 8) * 8
            smem = mlr_smem(kc, splits, d)
            if smem <= SMEM_CAP:
                return MlrPlan(True, kc, -(-k // kc), splits, smem)
    return None


def mlr_plan(n: int, k: int, d: int) -> MlrPlan:
    """The launch plan for x [n, d] and k classes: :func:`tile_plan`, or
    the pair kernel for rows too wide for the tiles and for launches of
    few logits (at most ``PAIR_LOGITS`` and ``PAIR_LOGITS_PER_CLASS`` a
    class of the tile plan's chunk)."""
    plan = tile_plan(n, k, d)
    if plan is None or n * k <= (PAIR_LOGITS
                                 + PAIR_LOGITS_PER_CLASS * plan.kc):
        return PAIR
    return plan


_DEVICE_C: dict = {}


def device_curvature(c, device: torch.device) -> torch.Tensor:
    """``c`` as the [1] float32 tensor on ``device`` the kernel reads: a
    tensor reshaped (cast if it is not f32), a number from a tensor made
    once per (device, value) and kept."""
    if isinstance(c, torch.Tensor):
        if c.numel() != 1 or c.device != device:
            raise ValueError(f"hyp_mlr: c must be one value on {device}; "
                             f"got shape {tuple(c.shape)} on {c.device}")
        return c.detach().to(torch.float32).reshape(1).contiguous()
    key = (device, float(c))
    if key not in _DEVICE_C:
        _DEVICE_C[key] = torch.full((1,), float(c), dtype=torch.float32,
                                    device=device)
    return _DEVICE_C[key]


def _launch(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
            c) -> torch.Tensor:
    S.check_cuda("hyp_mlr", (torch.float32,), x, p, a)
    n, d = x.shape
    k = p.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    cd = device_curvature(c, x.device)
    plan = mlr_plan(n, k, d)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = S.function("mlr", "hs_hyp_mlr", [P, P, P, P, L, I, I, P, I, I, I,
                                          P])
    S.check(fn(x.data_ptr(), p.data_ptr(), a.data_ptr(), out.data_ptr(), n,
               k, d, cd.data_ptr(), int(plan.tile), plan.kc, plan.splits,
               S.stream_ptr(x)), "hyp_mlr")
    hyp_mlr.launches += 1
    return out


def _forward(x2d, p, a, c):
    devs = {x2d.device, p.device, a.device}
    if devs == {torch.device("cpu")}:
        return hyp_mlr_plain(x2d, p, a, c)
    if any(dv.type != "cuda" for dv in devs):
        raise ValueError(f"hyp_mlr: unsupported device "
                         f"{sorted(map(str, devs))}")
    return _launch(x2d, p, a, c)


class _HypMLR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, p, a, c):
        ctx.c_is_tensor = isinstance(c, torch.Tensor)
        ctx.save_for_backward(x2d, p, a, *((c,) if ctx.c_is_tensor else ()))
        ctx.c = None if ctx.c_is_tensor else c
        return _forward(x2d, p, a, c)

    @staticmethod
    def backward(ctx, g):
        want_c = ctx.c_is_tensor and ctx.needs_input_grad[3]
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved[:3]]
            c = (saved[3].detach().requires_grad_(want_c)
                 if ctx.c_is_tensor else ctx.c)
            out = hyp_mlr_plain(*ins, c)
            grads = torch.autograd.grad(out, ins + ([c] if want_c else []),
                                        g)
        return (*grads[:3], grads[3] if want_c else None)


def hyp_mlr(x: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
            c) -> torch.Tensor:
    """Hyperbolic-MLR logits [..., K] for ball points x [..., d],
    hyperplane points p [K, d] and normals a [K, d] at curvature c (a
    number, or a one-value tensor on x's device, whose gradient the
    backward returns); see the module docstring."""
    if p.ndim != 2 or a.shape != p.shape or x.shape[-1] != p.shape[1]:
        raise ValueError(f"hyp_mlr: want x [..., d], p and a [K, d]; got "
                         f"{tuple(x.shape)}, {tuple(p.shape)}, "
                         f"{tuple(a.shape)}")
    lead = x.shape[:-1]
    out = _HypMLR.apply(x.reshape(-1, x.shape[-1]).contiguous(),
                        p.contiguous(), a.contiguous(), c)
    return out.reshape(lead + out.shape[-1:])


hyp_mlr.launches = 0
