"""The Poincaré ball's row-wise ops (counterpart of
``hyperspace_tpu/kernels/pointwise.py``, kernels N1–N4): ``mobius_add``,
``mobius_scalar_mul``, ``expmap``, ``logmap``, ``expmap0``, ``logmap0``
and ``ptransp``.

Each op takes [..., d] tensors that broadcast against each other and a
curvature ``c`` (a number or a 0-dim tensor; ``mobius_scalar_mul`` also a
scalar ``r``).  For CPU tensors it runs its plain version, the
:class:`PoincareBall` method (JAX's twin); for CUDA tensors it launches
``csrc/pointwise.cu`` (f32 or bf16 in, f32 inside); anything else raises.
The output has the first tensor's dtype, as the TPU launcher's.  The
gradient is autograd of the plain version on the saved inputs, as JAX's
``custom_vjp`` takes the twin's VJP: it reaches every tensor input,
``c`` and ``r`` included when they are tensors.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.manifolds.poincare import PoincareBall

_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def mobius_add_plain(x, y, c):
    """x ⊕_c y."""
    return PoincareBall(c).mobius_add(x, y)


def mobius_scalar_mul_plain(r, x, c):
    """r ⊗_c x."""
    return PoincareBall(c).mobius_scalar_mul(r, x)


def expmap_plain(x, v, c):
    """exp_x(v)."""
    return PoincareBall(c).expmap(x, v)


def logmap_plain(x, y, c):
    """log_x(y)."""
    return PoincareBall(c).logmap(x, y)


def expmap0_plain(v, c):
    """exp_0(v)."""
    return PoincareBall(c).expmap0(v)


def logmap0_plain(y, c):
    """log_0(y)."""
    return PoincareBall(c).logmap0(y)


def ptransp_plain(x, y, v, c):
    """P_{x→y}(v)."""
    return PoincareBall(c).ptransp(x, y, v)


# op name → (C launcher, plain version taking (tensors..., c, r))
_OPS = {
    "mobius_add": ("hs_mobius_add", lambda x, y, c, r: mobius_add_plain(
        x, y, c)),
    "mobius_scalar_mul": ("hs_mobius_scalar_mul",
                          lambda x, c, r: mobius_scalar_mul_plain(r, x, c)),
    "expmap": ("hs_expmap", lambda x, v, c, r: expmap_plain(x, v, c)),
    "logmap": ("hs_logmap", lambda x, y, c, r: logmap_plain(x, y, c)),
    "expmap0": ("hs_expmap0", lambda v, c, r: expmap0_plain(v, c)),
    "logmap0": ("hs_logmap0", lambda y, c, r: logmap0_plain(y, c)),
    "ptransp": ("hs_ptransp", lambda x, y, v, c, r: ptransp_plain(x, y, v,
                                                                  c)),
}


def device_scalar(name: str, s, dev: torch.device):
    """(tensor to keep alive, device pointer, value) of a scalar argument
    for a launcher: a tensor on the card is read there (no host
    synchronisation), anything else is passed by value."""
    if isinstance(s, torch.Tensor):
        if s.numel() != 1:
            raise ValueError(f"{name}: want a scalar, got shape "
                             f"{tuple(s.shape)}")
        if s.device.type == "cuda":
            if s.device != dev:
                raise ValueError(f"{name}: scalar on {s.device}, rows on "
                                 f"{dev}")
            t = s.detach().reshape(()).to(torch.float32).contiguous()
            return t, t.data_ptr(), 0.0
        return None, None, float(s)
    return None, None, float(s)


def _rows(t: torch.Tensor, shape, n: int, d: int):
    """``t`` broadcast to ``shape`` as [n, d] rows and its row stride: one
    row shared by every row keeps stride 0, else a contiguous copy."""
    if t.numel() == d and n > 1:
        return t.reshape(d).contiguous(), 0
    return torch.broadcast_to(t, shape).reshape(n, d).contiguous(), d


def _launch(op: str, tensors, c, r):
    dev = tensors[0].device
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    d = shape[-1]
    n = 1
    for s in shape[:-1]:
        n *= s
    out_dtype = tensors[0].dtype
    dtypes = {t.dtype for t in tensors}
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{op}: tensors on {t.device} and {dev}")
        if t.dtype not in _KINDS:
            raise ValueError(f"{op}: want float32 or bfloat16 on the card, "
                             f"got {t.dtype}")
    if len(dtypes) > 1:           # a mixed set is read as float32
        tensors = [t.to(torch.float32) for t in tensors]
    in_kind = _KINDS[tensors[0].dtype]
    rows = [_rows(t, shape, n, d) for t in tensors]
    rows += [(None, 0)] * (3 - len(rows))
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    c_keep, cp, cv = device_scalar(op, c, dev)
    r_keep, rp, rv = device_scalar(op, 0.0 if r is None else r, dev)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn = S.function("pointwise", _OPS[op][0],
                    [I, I, P, L, P, L, P, L, P, L, I, P, F, P, F, P])
    ptr = [None if t is None else t.data_ptr() for t, _ in rows]
    S.check(fn(in_kind, _KINDS[out_dtype], ptr[0], rows[0][1], ptr[1],
               rows[1][1], ptr[2], rows[2][1], out.data_ptr(), n, d, cp, cv,
               rp, rv, S.stream_ptr(out)), op)
    del c_keep, r_keep            # alive until the launch is queued
    _PUBLIC[op].launches += 1
    return out


def _forward(op: str, tensors, c, r):
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return _OPS[op][1](*tensors, c, r).to(tensors[0].dtype)
    if any(dv.type != "cuda" for dv in devs):
        raise ValueError(f"{op}: unsupported device "
                         f"{sorted(map(str, devs))}")
    return _launch(op, tensors, c, r)


class _Rowwise(torch.autograd.Function):
    """Forward: the kernel (or the plain version on the CPU); backward:
    autograd of the plain version on the saved inputs.  Arguments: the op
    name, how many tensors, the tensors, then c and r (each a number, a
    tensor or None)."""

    @staticmethod
    def forward(ctx, op, k, *args):
        tensors, scalars = list(args[:k]), list(args[k:])
        ctx.op, ctx.k = op, k
        ctx.is_t = [isinstance(s, torch.Tensor) for s in scalars]
        ctx.values = [None if t else s for s, t in zip(scalars, ctx.is_t)]
        ctx.save_for_backward(*tensors, *[s for s, t in zip(scalars,
                                                            ctx.is_t) if t])
        return _forward(op, tensors, *scalars)

    @staticmethod
    def backward(ctx, g):
        saved = iter(ctx.saved_tensors)
        with torch.enable_grad():
            ins = [next(saved).detach().requires_grad_()
                   for _ in range(ctx.k)]
            sc = [next(saved).detach().requires_grad_() if t else v
                  for t, v in zip(ctx.is_t, ctx.values)]
            out = _OPS[ctx.op][1](*ins, *sc).to(ins[0].dtype)
            wrt = ins + [s for s, t in zip(sc, ctx.is_t) if t]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        g_t = [next(grads) for _ in range(ctx.k)]
        return (None, None, *g_t, *[next(grads) if t else None
                                    for t in ctx.is_t])


def _apply(op: str, tensors, c, r=None):
    return _Rowwise.apply(op, len(tensors), *tensors, c, r)


def mobius_add(x: torch.Tensor, y: torch.Tensor, c) -> torch.Tensor:
    """x ⊕_c y (kernel N1)."""
    return _apply("mobius_add", [x, y], c)


def mobius_scalar_mul(r, x: torch.Tensor, c) -> torch.Tensor:
    """r ⊗_c x with a scalar r (kernel N2); r may be a tensor that
    requires grad."""
    return _apply("mobius_scalar_mul", [x], c, r)


def expmap(x: torch.Tensor, v: torch.Tensor, c) -> torch.Tensor:
    """exp_x(v) on the ball (kernel N3)."""
    return _apply("expmap", [x, v], c)


def logmap(x: torch.Tensor, y: torch.Tensor, c) -> torch.Tensor:
    """log_x(y) on the ball (kernel N3)."""
    return _apply("logmap", [x, y], c)


def expmap0(v: torch.Tensor, c) -> torch.Tensor:
    """exp_0(v) on the ball."""
    return _apply("expmap0", [v], c)


def logmap0(y: torch.Tensor, c) -> torch.Tensor:
    """log_0(y) on the ball."""
    return _apply("logmap0", [y], c)


def ptransp(x: torch.Tensor, y: torch.Tensor, v: torch.Tensor,
            c) -> torch.Tensor:
    """P_{x→y}(v) on the ball (kernel N4)."""
    return _apply("ptransp", [x, y, v], c)


_PUBLIC = {"mobius_add": mobius_add, "mobius_scalar_mul": mobius_scalar_mul,
           "expmap": expmap, "logmap": logmap, "expmap0": expmap0,
           "logmap0": logmap0, "ptransp": ptransp}
for _fn in _PUBLIC.values():
    _fn.launches = 0
