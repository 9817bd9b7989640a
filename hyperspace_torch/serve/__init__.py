"""k-NN / edge-score serving (counterpart of ``hyperspace_tpu.serve``):
artifact → :class:`QueryEngine` (exact, IVF-probed or PQ-coded scans) →
:class:`RequestBatcher` → ``cli.serve``; ``serve.index`` and
``serve.quant`` build the IVF index and the PQ codes."""

from hyperspace_torch.serve.artifact import (ServingArtifact, export_artifact,
                                             fingerprint_of, load_artifact)
from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.engine import QueryEngine

__all__ = ["QueryEngine", "RequestBatcher", "ServingArtifact",
           "export_artifact", "fingerprint_of", "load_artifact"]
