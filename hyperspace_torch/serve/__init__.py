"""k-NN / edge-score serving (counterpart of ``hyperspace_tpu.serve``):
artifact → :class:`QueryEngine` (exact, IVF-probed or PQ-coded scans) →
:class:`RequestBatcher` (buckets, cache, deadlines, admission, the
degradation ladder) → :class:`Collator` (continuous batching on one
dispatch thread) → :class:`HttpFrontDoor` → ``cli.serve``;
``serve.index`` and ``serve.quant`` build the IVF index and the PQ
codes, ``serve.access`` writes access logs and incident dumps."""

from hyperspace_torch.serve.artifact import (ServingArtifact, export_artifact,
                                             export_from_checkpoint,
                                             fingerprint_of, load_artifact)
from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.collator import Collator
from hyperspace_torch.serve.engine import QueryEngine
from hyperspace_torch.serve.server import HttpFrontDoor

__all__ = ["Collator", "HttpFrontDoor", "QueryEngine", "RequestBatcher",
           "ServingArtifact", "export_artifact", "export_from_checkpoint",
           "fingerprint_of", "load_artifact"]
