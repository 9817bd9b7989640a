"""Manifolds of the serving and HGCN training paths (counterpart of
``hyperspace_tpu.manifolds``)."""

from hyperspace_torch.manifolds.lorentz import Lorentz
from hyperspace_torch.manifolds.poincare import PoincareBall

__all__ = ["Lorentz", "PoincareBall"]
