"""Hyperbolic numerical-health monitor (counterpart of
``hyperspace_tpu/telemetry/health.py``): catch divergence before the NaN.

Poincaré embeddings drift to the ball's rim, where the conformal factor
and every gradient through artanh blow up (Nickel & Kiela 2017), and
hyperboloid points drift off ⟨x,x⟩_L = −1/c under f32 accumulation
(Chami et al. 2019).  :func:`health_stats` computes the leading
indicators on the device — each manifold's ``health_stats`` (the ball's
scaled radius and boundary margin, the hyperboloid's residual, a
product's per-factor merge), a global parameter norm, a nonfinite count
and, given a gradient-like tree, its global norm — and
:class:`HealthMonitor`, which ``train/loop.run_loop`` samples every
``health_every`` chunks, reads them in one host read, checks the
thresholds, logs a ``health/*`` record and warns or aborts.

``proj`` pins float32 ball points at a margin of 4e-3, well under the
default ``boundary_eps`` of 1e-2, so a table pushed to the rim flags at
once while healthy training (margins near 1) never does.  Each check
counts ``health/checks`` in the telemetry registry, each check that found
a problem ``health/warnings``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils._pytree as pytree

from hyperspace_torch.manifolds.base import Manifold, reduce_health_stats
from hyperspace_torch.telemetry import registry as telem

DEFAULT_BOUNDARY_EPS = 1e-2
DEFAULT_VIOLATION_TOL = 1e-3


def _float_leaves(tree) -> list:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _global_norm(leaves: list) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves))


@torch.no_grad()
def health_stats(params: Any, tags: Any = None, grads: Any = None,
                 grads_name: str = "grad_norm") -> dict:
    """Device scalars for a parameter tree.  ``tags`` is one
    :class:`Manifold` (``params`` a point tensor on it), a tag structure
    matching ``params`` (``optim.tags``), or None (Euclidean: norms and
    finiteness only); same-named stats of several leaves merge by
    :func:`reduce_health_stats`.  ``grads`` adds its global norm as
    ``grads_name``."""
    leaves = _float_leaves(params)
    out = {"nonfinite": sum(torch.sum(~torch.isfinite(t)).to(torch.int32)
                            for t in leaves),
           "param_norm": _global_norm(leaves)}
    collected: list = []
    if isinstance(tags, Manifold):
        collected.append(tags.health_stats(params))
    elif tags is not None:
        from hyperspace_torch.optim.tags import map_tagged

        map_tagged(lambda t, p: collected.append(t.health_stats(p))
                   if t is not None else None, tags, params)
    out.update(reduce_health_stats(collected))
    if grads is not None:
        out[grads_name] = _global_norm(_float_leaves(grads))
    return out


def make_health_fn(tags: Any = None, params_of: Optional[Callable] = None,
                   grads_of: Optional[Callable] = None,
                   grads_name: str = "grad_norm") -> Callable:
    """``fn(state) -> {name: device scalar}`` for run_loop: the
    parameters by ``params_of`` (default ``state.params``, else the state
    itself), a gradient-like tree by ``grads_of``."""

    def fn(state):
        params = (params_of(state) if params_of is not None
                  else getattr(state, "params", state))
        grads = grads_of(state) if grads_of is not None else None
        return health_stats(params, tags, grads=grads, grads_name=grads_name)

    return fn


class HealthMonitor:
    """Threshold checks on a sampled health fn.  ``check(state, step,
    log)`` reads the stats (one host read), writes one record of
    ``health/*`` fields and ``health/ok``, and warns — or raises
    ``FloatingPointError`` with ``abort=True`` — when a value is not
    finite or ``nonfinite > 0``, a ``*boundary_margin_min`` is below
    ``boundary_eps``, or a ``*violation_max`` is above
    ``violation_tol``."""

    def __init__(self, fn: Callable, *,
                 boundary_eps: float = DEFAULT_BOUNDARY_EPS,
                 violation_tol: float = DEFAULT_VIOLATION_TOL,
                 abort: bool = False):
        self.fn = fn
        self.boundary_eps = float(boundary_eps)
        self.violation_tol = float(violation_tol)
        self.abort = abort
        self.checks = 0
        self.warnings = 0

    def problems(self, vals: dict) -> list[str]:
        """The threshold violations of a sampled dict."""
        import math

        probs = []
        for k, v in vals.items():
            if not math.isfinite(v):
                probs.append(f"{k} is {v}")
            elif k == "nonfinite" and v > 0:
                probs.append(f"{int(v)} nonfinite values in state")
            elif k.endswith("boundary_margin_min") and v < self.boundary_eps:
                probs.append(f"{k}={v:.2e} < boundary_eps="
                             f"{self.boundary_eps:.0e}")
            elif k.endswith("violation_max") and v > self.violation_tol:
                probs.append(f"{k}={v:.2e} > violation_tol="
                             f"{self.violation_tol:.0e}")
        return probs

    def check(self, state: Any, step: int, log=None) -> dict:
        """Sample once; returns the host-side ``{name: float}``."""
        stats = self.fn(state)
        names = list(stats)
        values = torch.stack([torch.as_tensor(stats[k]).to(torch.float64)
                              for k in names]).tolist() if names else []
        vals = dict(zip(names, values))
        self.checks += 1
        telem.inc("health/checks")
        problems = self.problems(vals)
        if log is not None:
            rec = {f"health/{k}": v for k, v in vals.items()}
            rec["health/ok"] = not problems
            log.log(step, **rec)
        if problems:
            self.warnings += 1
            telem.inc("health/warnings")
            msg = f"[health] step {step}: " + "; ".join(problems)
            print(msg, flush=True)
            if self.abort:
                raise FloatingPointError(msg)
        return vals
