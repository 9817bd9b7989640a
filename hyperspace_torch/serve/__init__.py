"""k-NN / edge-score serving (counterpart of ``hyperspace_tpu.serve``):
artifact → :class:`QueryEngine` (exact, IVF-probed or PQ-coded scans) →
:class:`RequestBatcher` (buckets, cache, deadlines, admission, the
degradation ladder) → :class:`Collator` (continuous batching on one
dispatch thread) → :class:`HttpFrontDoor` → ``cli.serve``;
:class:`LiveQueryEngine` puts a mutable delta segment in front of a
frozen engine, :class:`EngineRegistry` serves many artifacts behind one
door (fair dispatch, engine paging) and :class:`RolloverCoordinator`
flips a door onto another artifact; ``serve.index`` and ``serve.quant``
build the IVF index and the PQ codes, ``serve.access`` writes access
logs and incident dumps."""

from hyperspace_torch.serve.artifact import (ServingArtifact, export_artifact,
                                             export_from_checkpoint,
                                             fingerprint_of, load_artifact)
from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.collator import Collator, FairDispatcher
from hyperspace_torch.serve.delta import LiveQueryEngine
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.serve.errors import UnknownTenantError
from hyperspace_torch.serve.registry import (EngineRegistry, TenantStack,
                                             engine_device_bytes)
from hyperspace_torch.serve.rollover import (RolloverCoordinator, gate_flip,
                                             standby_health)
from hyperspace_torch.serve.server import HttpFrontDoor

__all__ = ["Collator", "EngineRegistry", "FairDispatcher", "HttpFrontDoor",
           "LiveQueryEngine", "QueryEngine", "RequestBatcher",
           "RolloverCoordinator", "ServingArtifact", "TenantStack",
           "UnknownTenantError", "engine_device_bytes", "export_artifact",
           "export_from_checkpoint", "fingerprint_of", "gate_flip",
           "load_artifact", "standby_health"]
