"""Manifolds of the port (counterpart of ``hyperspace_tpu.manifolds``):
the Poincaré ball, the Lorentz hyperboloid, flat Euclidean space and the
maps between the two hyperbolic models."""

from hyperspace_torch.manifolds import smath  # noqa: F401
from hyperspace_torch.manifolds.base import Manifold
from hyperspace_torch.manifolds.euclidean import Euclidean
from hyperspace_torch.manifolds.lorentz import Lorentz, minkowski_dot
from hyperspace_torch.manifolds.maps import (ball_tangent_to_lorentz,
                                             ball_to_lorentz,
                                             lorentz_tangent_to_ball,
                                             lorentz_to_ball)
from hyperspace_torch.manifolds.poincare import PoincareBall

__all__ = ["Manifold", "Euclidean", "Lorentz", "minkowski_dot", "PoincareBall",
           "ball_to_lorentz", "lorentz_to_ball", "ball_tangent_to_lorentz",
           "lorentz_tangent_to_ball"]
