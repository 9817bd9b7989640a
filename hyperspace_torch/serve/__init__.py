"""Exact k-NN / edge-score serving (counterpart of ``hyperspace_tpu.serve``):
artifact → :class:`QueryEngine` → :class:`RequestBatcher` → ``cli.serve``."""

from hyperspace_torch.serve.artifact import (ServingArtifact, export_artifact,
                                             fingerprint_of, load_artifact)
from hyperspace_torch.serve.batcher import RequestBatcher
from hyperspace_torch.serve.engine import QueryEngine

__all__ = ["QueryEngine", "RequestBatcher", "ServingArtifact",
           "export_artifact", "fingerprint_of", "load_artifact"]
