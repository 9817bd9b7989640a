"""Failure-domain hardening (counterpart of ``hyperspace_tpu.resilience``):

- :mod:`faults` — the process-wide, seeded fault registry behind the
  ``chaos=`` flag (the ``serve.dispatch``, ``ckpt.save`` and
  ``train.step_nan`` sites);
- :mod:`guard` — the training divergence guard: on a non-finite loss or
  a health violation the loop rewinds to the last committed checkpoint
  under a capped budget and records the incident;
- :mod:`degrade` — the hysteresis ladder the serve batcher steps down
  under pressure (IVF ``nprobe`` toward 1, then cache-only answering).
"""

from hyperspace_torch.resilience import faults
from hyperspace_torch.resilience.degrade import HysteresisLadder
from hyperspace_torch.resilience.faults import (FaultSpec, InjectedCrash,
                                                InjectedIOError, parse_chaos)
from hyperspace_torch.resilience.guard import (DivergenceError,
                                               RollbackController,
                                               RollbackExhausted)

__all__ = ["faults", "FaultSpec", "InjectedCrash", "InjectedIOError",
           "parse_chaos", "HysteresisLadder", "DivergenceError",
           "RollbackController", "RollbackExhausted"]
