"""MNIST for the hyperbolic VAE (counterpart of
``hyperspace_tpu/data/mnist.py``; numpy only).

Reads the standard IDX files (``train-images-idx3-ubyte`` and
``train-labels-idx1-ubyte``, raw or ``.gz``) from a directory that holds
them; without one, :func:`synthetic_mnist` makes an MNIST-shaped set of
class-conditioned blob images, bit for bit the JAX package's for the
same arguments.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct

import numpy as np


@dataclasses.dataclass
class ImageDataset:
    images: np.ndarray  # [N, H, W] float32 in [0, 1]
    labels: np.ndarray  # [N] int32

    def split(self, train_frac: float = 0.9, seed: int = 0):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self.labels))
        n_tr = int(len(perm) * train_frac)

        def pick(idx):
            return ImageDataset(self.images[idx], self.labels[idx])

        return pick(perm[:n_tr]), pick(perm[n_tr:])


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">H", f.read(4)[2:])
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_idx_dir(root: str, prefix: str = "train") -> ImageDataset:
    def find(stem):
        for suffix in ("", ".gz"):
            p = os.path.join(root, stem + suffix)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(stem)

    images = _read_idx(find(f"{prefix}-images-idx3-ubyte")).astype(
        np.float32) / 255.0
    labels = _read_idx(find(f"{prefix}-labels-idx1-ubyte")).astype(np.int32)
    return ImageDataset(images, labels)


def synthetic_mnist(num_samples: int = 4096, num_classes: int = 10,
                    size: int = 28, seed: int = 0) -> ImageDataset:
    """Class-conditioned blob images: each class has three fixed blob
    centres; a sample jitters them and sums Gaussian blobs, clipped to
    [0, 1]."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(4, size - 4, size=(num_classes, 3, 2))
    labels = rng.integers(0, num_classes, num_samples).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    images = np.zeros((num_samples, size, size), np.float32)
    jitter = rng.normal(0, 1.0, size=(num_samples, 3, 2))
    for i, y in enumerate(labels):
        img = np.zeros((size, size), np.float32)
        for b in range(3):
            cy, cx = centers[y, b] + jitter[i, b]
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0**2))
        images[i] = np.clip(img, 0, 1)
    return ImageDataset(images, labels)


def load_mnist(root: str | None = None,
               **synth_kw) -> tuple[ImageDataset, str]:
    """(dataset, source): the IDX files under ``root`` (``"disk"``), else
    :func:`synthetic_mnist` (``"synthetic"``)."""
    if root is not None and os.path.isdir(root):
        try:
            return load_idx_dir(root), "disk"
        except FileNotFoundError:
            pass
    return synthetic_mnist(**synth_kw), "synthetic"
