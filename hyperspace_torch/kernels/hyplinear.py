"""The fused gyro-linear layer y = proj((M ⊗_c x) ⊕_c b) (counterpart of
``hyperspace_tpu/kernels/hyplinear.py``, kernel N5; Ganea et al. 2018).

:func:`hyp_linear` launches ``csrc/hyplinear.cu`` for CUDA tensors (x f32
or bf16, M and b read as f32, the product at f32 accuracy on the tensor
cores (3×TF32), each output written once, any (d_in, d_out)) and runs
:func:`hyp_linear_plain`, the manifold-method composition (JAX's twin
``_t_hyp_linear``), for CPU tensors.  The JAX package's quiet fall back
to its twin above a VMEM budget is not carried over.  The gradient is
autograd of the plain version on the saved inputs, to x, M, b and a
tensor c, as JAX's ``custom_vjp`` takes the twin's VJP.
"""

from __future__ import annotations

import ctypes

import torch

from hyperspace_torch.kernels import _support as S
from hyperspace_torch.kernels.pointwise import _KINDS, device_scalar
from hyperspace_torch.manifolds.poincare import PoincareBall


def hyp_linear_plain(x: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                     c) -> torch.Tensor:
    """proj(mobius_add(mobius_matvec(m, x), b)) by the ball's methods."""
    ball = PoincareBall(c)
    return ball.proj(ball.mobius_add(ball.mobius_matvec(m, x), b))


def _launch(x: torch.Tensor, m: torch.Tensor, b: torch.Tensor, c):
    dev = x.device
    if x.dtype not in _KINDS:
        raise ValueError(f"hyp_linear: want float32 or bfloat16 x on the "
                         f"card, got {x.dtype}")
    for t in (m, b):
        if t.device != dev:
            raise ValueError(f"hyp_linear: tensors on {t.device} and {dev}")
        if t.dtype not in _KINDS:
            raise ValueError(f"hyp_linear: want float32 or bfloat16 "
                             f"weights on the card, got {t.dtype}")
    d_in, d_out = m.shape
    x2 = x.reshape(-1, d_in).contiguous()
    n = x2.shape[0]
    mf = m.to(torch.float32).contiguous()
    bf = b.reshape(d_out).to(torch.float32).contiguous()
    out = torch.empty((n, d_out), dtype=x.dtype, device=dev)
    c_keep, cp, cv = device_scalar("hyp_linear", c, dev)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = S.function("hyplinear", "hs_hyp_linear",
                    [I, P, P, P, P, L, I, I, P, ctypes.c_float, P])
    S.check(fn(_KINDS[x.dtype], x2.data_ptr(), mf.data_ptr(), bf.data_ptr(),
               out.data_ptr(), n, d_in, d_out, cp, cv, S.stream_ptr(x)),
            "hyp_linear")
    del c_keep
    hyp_linear.launches += 1
    return out.reshape(x.shape[:-1] + (d_out,))


def _forward(x, m, b, c):
    devs = {x.device, m.device, b.device}
    if devs == {torch.device("cpu")}:
        return hyp_linear_plain(x, m, b, c).to(x.dtype)
    if any(dv.type != "cuda" for dv in devs):
        raise ValueError(f"hyp_linear: unsupported device "
                         f"{sorted(map(str, devs))}")
    return _launch(x, m, b, c)


class _HypLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, b, c):
        ctx.c_is_t = isinstance(c, torch.Tensor)
        ctx.c = None if ctx.c_is_t else c
        ctx.save_for_backward(x, m, b, *([c] if ctx.c_is_t else []))
        return _forward(x, m, b, c)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            c = ins[3] if ctx.c_is_t else ctx.c
            out = hyp_linear_plain(*ins[:3], c).to(ins[0].dtype)
            grads = torch.autograd.grad(out, ins, g, allow_unused=True)
        return (*grads[:3], grads[3] if ctx.c_is_t else None)


def hyp_linear(x: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
               c) -> torch.Tensor:
    """Fused gyro-linear proj((M ⊗_c x) ⊕_c b) (kernel N5): x [..., d_in]
    ball points, m [d_in, d_out], b [d_out] a ball point (zeros for a
    layer without bias: x ⊕ 0 = x exactly), c a number or a 0-dim
    tensor."""
    if (m.ndim != 2 or x.shape[-1] != m.shape[0]
            or b.numel() != m.shape[1]):
        raise ValueError(f"hyp_linear: want x [..., d_in], m [d_in, d_out], "
                         f"b [d_out]; got {tuple(x.shape)}, "
                         f"{tuple(m.shape)}, {tuple(b.shape)}")
    return _HypLinear.apply(x, m, b, c)


hyp_linear.launches = 0
