"""Hyperbolic flash attention (counterpart of
``hyperspace_tpu/kernels/attention.py``, kernel N7).

Scores are affine in the squared Lorentz distance,

    σ(q, k) = (−d²_L(q, k) + β)/τ = (2/c + 2⟨q, k⟩_L + β)/τ ,

and the values aggregate to the Lorentz centroid of the softmax weights
(an online-softmax numerator, then a row rescale onto the hyperboloid).

:func:`flash_attention` is the entry point.  It broadcasts β and τ to
one scalar per (batch, head) and the mask over heads *outside*
:class:`_FlashAttention`, so autograd sums their cotangents over the
broadcast.  The Function's forward is :func:`flash_fwd` and its backward
(following ``_fa3_bwd``) is the epilogue's VJP in PyTorch, then
:func:`flash_dq` and :func:`flash_dkv`; dβ ≡ 0 (a softmax does not move
under a shift), dτ = −Σ dσ·σ/τ, and dc comes from the epilogue only.  The
three wrappers launch ``csrc/attention.cu`` for CUDA tensors and run
their plain PyTorch versions for CPU tensors.  Per-position β/τ go to
:func:`flash_attention_plain`, the dense twin, with plain autograd, as
in JAX.

The kernels take f32 only.  The mask is carried as uint8 [B/group, Nq,
Nk] with ``group`` consecutive (batch·head) rows sharing one mask (the
heads of a sequence), not as JAX's dense f32 [B·h, Nq, Nk]; its meaning
(> 0 attends) is unchanged.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.manifolds import smath

NEG = -1e30          # finite −inf surrogate of the recurrence
LSE_EMPTY = 1e30     # lse of a row with no valid key
EPS_F32 = 1e-7
MIN_NORM_F32 = 1e-12
MAX_D = 72           # widest row the CUDA kernels take (D ≤ 72)


def _flip(x: torch.Tensor) -> torch.Tensor:
    """J x: lane 0 (time) negated."""
    return torch.cat([-x[..., :1], x[..., 1:]], dim=-1)


def flash_attention_plain(q, k, v, c, beta=0.0, tau=1.0, mask=None):
    """The dense twin (``_t_flash_attention``): softmax over every key,
    fully-masked rows set to 0 by ``torch.where`` (never by a product),
    then the centroid rescale with the manifold clamps of q's dtype."""
    cc = smath.as_scalar(c, q)
    gram = torch.matmul(q, _flip(k).transpose(-1, -2))
    logits = (2.0 / cc + 2.0 * gram + beta) / tau
    if mask is not None:
        logits = torch.where(mask > 0, logits, -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    s = torch.matmul(w, v)
    sp = (torch.sum(s[..., 1:] * s[..., 1:], dim=-1, keepdim=True)
          - s[..., :1] * s[..., :1])
    nrm = smath.safe_sqrt(smath.clamp_min(-sp, smath.eps_for(q.dtype)))
    return s / (smath.safe_sqrt(cc) * nrm)


# --- the plain versions of the three kernels ---------------------------------


def _valid(mask3: Optional[torch.Tensor], group: int, b: int, nq: int,
           nk: int, device) -> torch.Tensor:
    if mask3 is None:
        return torch.ones((b, nq, nk), dtype=torch.bool, device=device)
    return mask3.repeat_interleave(group, dim=0) > 0


def _two_over_c(c: float) -> float:
    """2/c as the f32 kernels compute it."""
    return float(np.float32(2.0) / np.float32(c))


def _sigma(q, k, c, beta_b, tau_b):
    gram = torch.matmul(q, _flip(k).transpose(-1, -2))
    return ((_two_over_c(c) + 2.0 * gram + beta_b[:, None, None])
            / tau_b[:, None, None])


def flash_fwd_plain(q, k, v, c: float, beta_b, tau_b, mask3, group):
    """The forward kernel's arithmetic, dense: (out [B, Nq, D], lse
    [B, Nq], nrm [B, Nq]) with the kernel's clamps."""
    b, nq, _ = q.shape
    valid = _valid(mask3, group, b, nq, k.shape[1], q.device)
    logits = torch.where(valid, _sigma(q, k, c, beta_b, tau_b), NEG)
    m = torch.amax(logits, dim=-1, keepdim=True) if k.shape[1] else \
        torch.full((b, nq, 1), NEG, dtype=q.dtype, device=q.device)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    s = torch.matmul(p, v) / torch.clamp_min(l, MIN_NORM_F32)
    sp = (torch.sum(s[..., 1:] * s[..., 1:], dim=-1, keepdim=True)
          - s[..., :1] * s[..., :1])
    nrm = torch.sqrt(torch.clamp_min(-sp, EPS_F32))
    sc = max(math.sqrt(max(c, 0.0)), MIN_NORM_F32)
    out = s / (sc * nrm)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-38)),
                      LSE_EMPTY)
    return out, lse[..., 0], nrm[..., 0]


def _bwd_plain(q, k, v, c, beta_b, tau_b, mask3, group, dsp, lse, di):
    b, nq, _ = q.shape
    valid = _valid(mask3, group, b, nq, k.shape[1], q.device)
    sigma = _sigma(q, k, c, beta_b, tau_b)
    p = torch.where(valid, torch.exp(sigma - lse[..., None]), 0.0)
    dsig = torch.where(valid, p * (torch.matmul(dsp, v.transpose(-1, -2))
                                   - di[..., None]), 0.0)
    return p, dsig, sigma, valid


def flash_dq_plain(q, k, v, c: float, beta_b, tau_b, mask3, group, dsp,
                   lse, di):
    """The dq kernel's arithmetic, dense: (dq [B, Nq, D], dst [B]) with
    dst = Σ dσ·σ per (batch·head)."""
    _, dsig, sigma, valid = _bwd_plain(q, k, v, c, beta_b, tau_b, mask3,
                                       group, dsp, lse, di)
    dq = (2.0 / tau_b[:, None, None]) * torch.matmul(dsig, _flip(k))
    dst = torch.sum(torch.where(valid, dsig * sigma, 0.0), dim=(1, 2))
    return dq, dst


def flash_dkv_plain(q, k, v, c: float, beta_b, tau_b, mask3, group, dsp,
                    lse, di):
    """The dk/dv kernel's arithmetic, dense: (dk, dv), each [B, Nk, D]."""
    p, dsig, _, _ = _bwd_plain(q, k, v, c, beta_b, tau_b, mask3, group,
                               dsp, lse, di)
    dv = torch.matmul(p.transpose(-1, -2), dsp)
    dk = (2.0 / tau_b[:, None, None]) * torch.matmul(dsig.transpose(-1, -2),
                                                     _flip(q))
    return dk, dv


# --- the kernel wrappers -----------------------------------------------------


def _check(name, q, k, v, beta_b, tau_b, mask3, group, *more):
    """Shapes for every device; device, dtype and contiguity for CUDA."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or (
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]):
        raise ValueError(f"{name}: want q [B, Nq, D], k and v [B, Nk, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, nq, d = q.shape
    if beta_b.shape != (b,) or tau_b.shape != (b,):
        raise ValueError(f"{name}: want beta and tau [{b}]")
    if mask3 is not None and (group < 1 or b % group or mask3.shape != (
            b // group, nq, k.shape[1])):
        raise ValueError(f"{name}: want a mask [{b}/{group}, {nq}, "
                         f"{k.shape[1]}]; got {tuple(mask3.shape)}")
    devs = {t.device for t in (q, k, v, beta_b, tau_b, *more)}
    if mask3 is not None:
        devs.add(mask3.device)
    if devs == {torch.device("cpu")}:
        return False
    if any(dv.type != "cuda" for dv in devs):
        raise ValueError(f"{name}: unsupported device "
                         f"{sorted(map(str, devs))}")
    if d > MAX_D:
        raise ValueError(f"{name}: rows of width {d} > {MAX_D}")
    S.check_cuda(name, (torch.float32,), q, k, v, beta_b, tau_b, *more)
    if mask3 is not None:
        S.check_cuda(name, (torch.uint8,), mask3)
        if mask3.device != q.device:
            raise ValueError(f"{name}: mask on {mask3.device}")
    return True


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bits_scratch(mask3, rows: int, cols: int):
    """Scratch for the mask as bits, one int32 word per 32 columns of
    each of a sequence's ``rows`` rows; None without a mask."""
    if mask3 is None:
        return None
    return torch.empty(mask3.shape[0] * rows * -(-cols // 32),
                       dtype=torch.int32, device=mask3.device)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, which: int, d: int) -> int:
    """Blocks of the dq (``which`` 0) or dk/dv (1) kernel at width d
    resident on one streaming multiprocessor of device ``index``."""
    fn = S.function("attention", "hs_flash_bwd_blocks_per_sm", [_I, _I])
    with torch.cuda.device(index):
        n = fn(which, d)
    if n < 1:
        raise RuntimeError(f"flash backward: occupancy query failed ({n})")
    return n


def split_count(blocks: int, tiles: int, sms: int, per_sm: int) -> int:
    """Parts a backward kernel cuts the other side into: a launch of
    ``blocks`` blocks a part, each part ``tiles``/parts of the other
    side's 64-row tiles (the parts differ by one at most), ``per_sm``
    blocks resident on each of ``sms`` SMs.  From the fewest parts that
    put two blocks on every SM, the count that needs the fewest rounds of
    resident blocks × (tiles of the longest part + 1, its set-up) wins,
    the fewer parts on a tie; never more parts than tiles, so none is
    empty."""
    if tiles <= 1:
        return 1
    lo = min(tiles, -(-2 * sms // max(blocks, 1)))
    return min(range(lo, min(tiles, lo + 8) + 1),
               key=lambda s: (-(-blocks * s // (sms * per_sm))
                              * (-(-tiles // s) + 1), s))


def _splits(device, which: int, b: int, rows: int, other: int,
            d: int) -> int:
    """:func:`split_count` for a launch on ``device`` with b·ceil(rows/64)
    blocks a part and the kernel's occupancy at width d."""
    return split_count(b * -(-rows // 64), -(-other // 64),
                       _sm_count(device.index),
                       _blocks_per_sm(device.index, which, d))


def flash_fwd(q, k, v, c: float, beta_b, tau_b, mask3=None, group: int = 1):
    """Forward kernel: (out [B, Nq, D], lse [B, Nq], nrm [B, Nq]) for q
    [B, Nq, D], k and v [B, Nk, D], β and τ [B], mask3 None or uint8
    [B/group, Nq, Nk].  CUDA tensors (f32, contiguous) launch
    ``hs_flash_fwd``; CPU tensors take :func:`flash_fwd_plain`."""
    if not _check("flash_fwd", q, k, v, beta_b, tau_b, mask3, group):
        return flash_fwd_plain(q, k, v, c, beta_b, tau_b, mask3, group)
    b, nq, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    nrm = torch.empty_like(lse)
    bits = _bits_scratch(mask3, nq, nk)
    fn = S.function("attention", "hs_flash_fwd",
                    [_P, _P, _P, _P, _I, _P, _P, _P, _F, _I, _I, _I, _I, _P,
                     _P, _P, _P])
    S.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask3), group,
               _ptr(bits), beta_b.data_ptr(), tau_b.data_ptr(), c, b, nq, nk,
               d, out.data_ptr(), lse.data_ptr(), nrm.data_ptr(),
               S.stream_ptr(q)), "flash_fwd")
    flash_fwd.launches += 1
    return out, lse, nrm


def flash_dq(q, k, v, c: float, beta_b, tau_b, mask3, group, dsp, lse, di):
    """dq kernel: (dq [B, Nq, D], dst [B]) from the epilogue's cotangent
    dsp [B, Nq, D], lse and di = Σ dsp·s_pre [B, Nq].  The kernel writes
    one partial of Σ dσ·σ per 64-query block and part of the keys; they
    are summed here in a fixed order."""
    if not _check("flash_dq", q, k, v, beta_b, tau_b, mask3, group, dsp,
                  lse, di):
        return flash_dq_plain(q, k, v, c, beta_b, tau_b, mask3, group, dsp,
                              lse, di)
    b, nq, d = q.shape
    nk = k.shape[1]
    splits = _splits(q.device, 0, b, nq, nk, d)
    dq = torch.empty_like(q)
    dq_part = None if splits == 1 else q.new_empty((splits,) + q.shape)
    part = torch.empty((b, splits * -(-nq // 64)), dtype=torch.float32,
                       device=q.device)
    bits = _bits_scratch(mask3, nq, nk)
    fn = S.function("attention", "hs_flash_dq",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _F, _I, _I,
                     _I, _I, _I, _P, _P, _P, _P])
    S.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dsp.data_ptr(),
               lse.data_ptr(), di.data_ptr(), _ptr(mask3), group, _ptr(bits),
               beta_b.data_ptr(), tau_b.data_ptr(), c, b, nq, nk, d, splits,
               dq.data_ptr(), _ptr(dq_part), part.data_ptr(),
               S.stream_ptr(q)), "flash_dq")
    flash_dq.launches += 1
    return dq, part[:, 0] if part.shape[1] == 1 else part.sum(dim=1)


def flash_dkv(q, k, v, c: float, beta_b, tau_b, mask3, group, dsp, lse, di):
    """dk/dv kernel: (dk, dv), each [B, Nk, D]."""
    if not _check("flash_dkv", q, k, v, beta_b, tau_b, mask3, group, dsp,
                  lse, di):
        return flash_dkv_plain(q, k, v, c, beta_b, tau_b, mask3, group, dsp,
                               lse, di)
    b, nq, d = q.shape
    nk = k.shape[1]
    splits = _splits(q.device, 1, b, nk, nq, d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dkv_part = None if splits == 1 else k.new_empty((2, splits) + k.shape)
    bits_t = _bits_scratch(mask3, nk, nq)   # the mask transposed, as bits
    fn = S.function("attention", "hs_flash_dkv",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _F, _I, _I,
                     _I, _I, _I, _P, _P, _P, _P])
    S.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dsp.data_ptr(),
               lse.data_ptr(), di.data_ptr(), _ptr(mask3), group,
               _ptr(bits_t), beta_b.data_ptr(), tau_b.data_ptr(), c, b, nq,
               nk, d, splits, dk.data_ptr(), dv.data_ptr(), _ptr(dkv_part),
               S.stream_ptr(q)), "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = flash_dq.launches = flash_dkv.launches = 0


def _epilogue(s: torch.Tensor, c) -> torch.Tensor:
    """The forward kernel's epilogue with its clamps (``_epilogue_jax``);
    the backward differentiates it with autograd."""
    sp = (torch.sum(s[..., 1:] * s[..., 1:], dim=-1, keepdim=True)
          - s[..., :1] * s[..., :1])
    nrm = torch.sqrt(smath.clamp_min(smath.clamp_min(-sp, EPS_F32), 0.0))
    cc = smath.as_scalar(c, s)          # a fill: a graph can capture it
    sc = smath.clamp_min(torch.sqrt(smath.clamp_min(cc, 0.0)), MIN_NORM_F32)
    return s / (sc * nrm)


class _FlashAttention(torch.autograd.Function):
    """Flash attention over [B, N, D] rows with per-row β, τ [B]; ``c``
    is a number or a 0-dim tensor (then it gets the epilogue's
    gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, c, beta_b, tau_b, mask3, group):
        c_val = float(c)
        out, lse, nrm = flash_fwd(q, k, v, c_val, beta_b, tau_b, mask3,
                                  group)
        ctx.save_for_backward(q, k, v, beta_b, tau_b, out, lse, nrm)
        ctx.c, ctx.mask3, ctx.group = c, mask3, group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, beta_b, tau_b, out, lse, nrm = ctx.saved_tensors
        c, mask3, group = ctx.c, ctx.mask3, ctx.group
        c_val = float(c)
        sc = max(math.sqrt(max(c_val, 0.0)), MIN_NORM_F32)
        s_pre = out * (sc * nrm[..., None])
        want_dc = ctx.needs_input_grad[3]
        with torch.enable_grad():
            s_in = s_pre.detach().requires_grad_()
            c_in = (c.detach().to(torch.float32).requires_grad_() if want_dc
                    else c_val)
            o = _epilogue(s_in, c_in)
            grads = torch.autograd.grad(
                o, (s_in, c_in) if want_dc else (s_in,), g)
        dsp = grads[0].contiguous()
        di = torch.sum(dsp * s_pre, dim=-1)
        dq, dst = flash_dq(q, k, v, c_val, beta_b, tau_b, mask3, group, dsp,
                           lse, di)
        dk, dv = flash_dkv(q, k, v, c_val, beta_b, tau_b, mask3, group, dsp,
                           lse, di)
        # β shifts a whole softmax row: dβ ≡ 0 exactly, and the same
        # row-sum identity removes the score-offset term of dc
        dbeta = torch.zeros_like(beta_b)
        dtau = -dst / tau_b
        dc = grads[1].to(c.dtype) if want_dc else None
        return dq, dk, dv, dc, dbeta, dtau, None, None


def _per_batch(x, lead, like: torch.Tensor) -> torch.Tensor:
    """A per-(batch, head) scalar spec (a number or [..., 1, 1]) broadcast
    to [B] in ``like``'s dtype, differentiably."""
    t = smath.as_scalar(x, like)        # a number is filled on the device
    return torch.broadcast_to(t, lead + (1, 1))[..., 0, 0].reshape(-1)


def _mask_rows(mask, lead, nq: int, nk: int):
    """(uint8 [B/group, Nq, Nk], group): a mask whose head axis (the last
    lead axis) broadcasts keeps one copy per sequence."""
    mb = torch.broadcast_to(mask, lead + (nq, nk))
    group = 1
    if len(lead) >= 1 and mb.stride(-3) == 0:
        mb, group = mb.select(-3, 0), lead[-1]
    return (mb > 0).to(torch.uint8).reshape(-1, nq, nk).contiguous(), group


def _per_position(x) -> bool:
    shape = tuple(getattr(x, "shape", ()))
    return len(shape) >= 2 and shape[-2:] != (1, 1)


def flash_attention(q, k, v, c, *, beta=0.0, tau=1.0, mask=None):
    """Hyperbolic flash attention (kernel N7).

    q [..., Nq, D], k and v [..., Nk, D] hyperboloid points; β and τ
    numbers or per-(batch, head) [..., 1, 1] tensors; mask bool or float
    broadcastable to [..., Nq, Nk], > 0 attends.  Returns hyperboloid
    points [..., Nq, D].  Per-position β or τ run the dense twin on CPU
    tensors and raise on CUDA tensors: the kernels take β and τ per
    (batch, head) only."""
    if _per_position(beta) or _per_position(tau):
        if q.device.type != "cpu":
            raise ValueError(
                "flash_attention: the CUDA kernels take beta and tau per "
                "(batch, head) only ([..., 1, 1]); per-position values run "
                "on CPU tensors alone")
        return flash_attention_plain(q, k, v, c, beta, tau, mask)
    lead = tuple(q.shape[:-2])
    nq, nk = q.shape[-2], k.shape[-2]
    q3 = q.reshape((-1,) + q.shape[-2:])
    k3 = torch.broadcast_to(k, lead + k.shape[-2:]).reshape(q3.shape[0], nk,
                                                            -1)
    v3 = torch.broadcast_to(v, lead + v.shape[-2:]).reshape(q3.shape[0], nk,
                                                            -1)
    beta_b = _per_batch(beta, lead, q)
    tau_b = _per_batch(tau, lead, q)
    mask3, group = (None, 1) if mask is None else _mask_rows(mask, lead, nq,
                                                             nk)
    out = _FlashAttention.apply(q3.contiguous(), k3.contiguous(),
                                v3.contiguous(), c, beta_b.contiguous(),
                                tau_b.contiguous(), mask3, group)
    return out.reshape(lead + out.shape[-2:])
