"""Link-prediction decoder (counterpart of ``hyperspace_tpu/nn/decoders.py``).

Fermi–Dirac (Chami et al. 2019): p(u ~ v) = 1 / (exp((d² − r) / t) + 1),
with learnable radius ``r`` and temperature ``t``; the module returns the
logit (r − d²) / t, whose sigmoid is that probability.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class FermiDiracDecoder(nn.Module):
    """Edge logits from squared distances; ``r`` starts at ``r_init`` and
    ``t = softplus(t_raw) + 1e-4`` at ``t_init``."""

    def __init__(self, r_init: float = 2.0, t_init: float = 1.0):
        super().__init__()
        self.r = nn.Parameter(torch.tensor(float(r_init)))
        self.t_raw = nn.Parameter(torch.tensor(math.log(math.expm1(t_init)),
                                               dtype=torch.float32))

    def forward(self, sqdist: torch.Tensor) -> torch.Tensor:
        t = nn.functional.softplus(self.t_raw) + 1e-4
        return (self.r - sqdist) / t
