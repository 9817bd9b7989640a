"""Per-chunk loss accumulation (counterpart of
``hyperspace_tpu/optim/metrics.py``).

A chunked stepper (``train/loop.make_chunked_stepper``) returns the
``[K]`` losses of one chunk on the device.  Reading each to the host per
step would bring back the per-step synchronisation the chunk removed, so
the loop keeps the device tensors and reduces them with one host read a
flush."""

from __future__ import annotations

import torch


class ChunkMetrics:
    """Accumulate chunk losses; ``flush()`` gives the stats since the
    last flush.  ``add`` takes a scalar or a ``[K]`` tensor and does not
    synchronise."""

    def __init__(self):
        self._chunks = []

    def add(self, losses) -> None:
        self._chunks.append(losses)

    def flush(self):
        """``{"loss_mean", "loss_last", "loss_min", "loss_max"}`` over
        every step added since the previous flush, from one host read;
        None when nothing was added."""
        if not self._chunks:
            return None
        vals = torch.cat([torch.as_tensor(c).reshape(-1).to(torch.float64)
                          for c in self._chunks]).cpu().numpy()
        self._chunks.clear()
        return {"loss_mean": float(vals.mean()),
                "loss_last": float(vals[-1]),
                "loss_min": float(vals.min()),
                "loss_max": float(vals.max())}
