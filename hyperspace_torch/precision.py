"""Mixed-precision policy, the part the HGCN, HyboNet and HVAE paths use
(counterpart of ``hyperspace_tpu/precision.py``).

A policy names a compute dtype; ``f32`` (the default) computes in
float32, ``bf16`` in bfloat16 — for HGCN that means the bf16 edge-message
lane (``agg_dtype``) and the bf16 training decoder lane
(``decoder_dtype``), while the encoder's matmuls, every manifold op and
every reduction stay float32; for HyboNet the LorentzLinear and
attention-projection matmuls (:func:`compute_matmul` with the policy's
:meth:`Policy.module_dtype`); for the HVAE the conv and dense stacks,
through the cast helpers (:meth:`Policy.cast_compute` at a stack's
input, :meth:`Policy.cast_boundary` before a manifold op,
:meth:`Policy.cast_accum` before a loss reduction).  Under ``f32`` every
helper returns its input unchanged.  :func:`parse_dtype` maps a flag
string such as ``"bfloat16"`` to a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

PRESET_NAMES = ("f32", "bf16")

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    compute: torch.dtype = torch.float32
    param: torch.dtype = torch.float32      # master parameters
    accum: torch.dtype = torch.float32      # reductions, losses
    boundary: torch.dtype = torch.float32   # manifold-op inputs

    @property
    def mixed(self) -> bool:
        """True when the compute dtype is not float32 — the only case in
        which a cast helper does anything."""
        return self.compute != torch.float32

    # --- cast helpers: the input itself under f32, and for a tensor that
    # is not floating point (ids, masks) or already of the dtype ----------

    def _cast(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        if self.mixed and x.is_floating_point() and x.dtype != dt:
            return x.to(dt)
        return x

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """Activation and matmul-input cast (to ``compute``)."""
        return self._cast(x, self.compute)

    def cast_boundary(self, x: torch.Tensor) -> torch.Tensor:
        """Cast of a manifold op's input (to ``boundary``, float32 in
        every preset)."""
        return self._cast(x, self.boundary)

    def cast_accum(self, x: torch.Tensor) -> torch.Tensor:
        """Cast of a reduction's input (to ``accum``)."""
        return self._cast(x, self.accum)

    def cast_param(self, x: torch.Tensor) -> torch.Tensor:
        """Master-parameter cast (to ``param``)."""
        return self._cast(x, self.param)

    def module_dtype(self) -> Optional[torch.dtype]:
        """The compute dtype a layer's matmuls take: ``compute`` when
        mixed, ``None`` (the plain matmul) otherwise."""
        return self.compute if self.mixed else None


F32 = Policy("f32")
BF16 = Policy("bf16", compute=torch.bfloat16)
_PRESETS = {"f32": F32, "bf16": BF16}


def get_policy(p: Union[None, str, Policy]) -> Policy:
    """Resolve ``None`` (→ f32), a preset name, or a Policy."""
    if p is None:
        return F32
    if isinstance(p, Policy):
        return p
    try:
        return _PRESETS[p]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown precision {p!r} (want one of {PRESET_NAMES})") from None


def compute_matmul(x: torch.Tensor, w: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` on the compute lane: both cast to ``compute_dtype`` and the
    product cast back to ``x.dtype``, so what follows (bias adds, time
    coordinates) runs in full precision.  ``None`` is the plain matmul."""
    if compute_dtype is None:
        return x @ w
    return (x.to(compute_dtype) @ w.to(compute_dtype)).to(x.dtype)


def parse_dtype(name: Union[str, torch.dtype, None],
                default: Optional[torch.dtype] = None) -> Any:
    """A dtype name (``"float32"``, ``"bfloat16"``, …) as a torch dtype;
    ``None`` gives ``default``, a dtype passes through."""
    if name is None:
        return default
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}") from None


def resolved_lane_dtype(explicit: Optional[torch.dtype],
                        precision: Union[None, str, Policy]):
    """A bf16 lane's dtype as executed: the explicit field, else the
    policy's compute dtype when mixed, else None (= the model dtype)."""
    if explicit is not None:
        return explicit
    pol = get_policy(precision)
    return pol.compute if pol.mixed else None
