"""Mixed-precision policy, the part the HGCN path uses (counterpart of
``hyperspace_tpu/precision.py``).

A policy names a compute dtype; ``f32`` (the default) computes in
float32, ``bf16`` in bfloat16 — for HGCN that means the bf16 edge-message
lane (``agg_dtype``) and the bf16 training decoder lane
(``decoder_dtype``), while the encoder's matmuls, every manifold op and
every reduction stay float32.  :func:`parse_dtype` maps a flag string
such as ``"bfloat16"`` to a torch dtype.
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

    @property
    def mixed(self) -> bool:
        """True when the compute dtype is not float32."""
        return self.compute != torch.float32


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
