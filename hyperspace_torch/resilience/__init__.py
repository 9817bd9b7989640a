"""Overload-safe serving (counterpart of ``hyperspace_tpu.resilience``):

- :mod:`faults` — the process-wide, seeded fault registry behind the
  ``chaos=`` flag (the ``serve.dispatch`` site);
- :mod:`degrade` — the hysteresis ladder the serve batcher steps down
  under pressure (IVF ``nprobe`` toward 1, then cache-only answering).

JAX's divergence guard (``guard.py``) is not ported yet.
"""

from hyperspace_torch.resilience import faults
from hyperspace_torch.resilience.degrade import HysteresisLadder
from hyperspace_torch.resilience.faults import (FaultSpec, InjectedCrash,
                                                InjectedIOError, parse_chaos)

__all__ = ["faults", "FaultSpec", "InjectedCrash", "InjectedIOError",
           "parse_chaos", "HysteresisLadder"]
