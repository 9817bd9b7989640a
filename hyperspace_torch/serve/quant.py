"""Quantized copies of the serve table for the coarse-scan lanes
(counterpart of ``hyperspace_tpu/serve/quant.py``).

- **int8**: a per-row symmetric code in [-127, 127] and a per-row f32
  scale; the scans dequantize ``code · scale`` in f32.
- **int4**: two signed nibbles a byte in the planar layout (byte ``j``
  holds element ``j`` low and element ``ceil(D/2) + j`` high) and a
  per-row f16 scale fitted first, so every reconstruction is
  ``nibble · float(scale)`` bit for bit.
- **PQ**, below.

The quantizers are host numpy, each the JAX package's step for step,
so codes and scales are array-equal to JAX's for the same table;
:func:`unpack_int4_torch` is the tensor twin of the nibble unpack that
the engine's two-stage scan applies to each chunk.

PQ splits a row's *lift* (``serve/index.py:_lift``: a poincare row
lifts to the hyperboloid, lorentz and euclidean rows lift to
themselves) into ``m`` subspaces of ``ds`` coordinates and stores one
uint8 centroid code per subspace.  For the lorentz-gram families the
scan distance depends on a candidate only through the additive
``⟨q_L, y_L⟩_L``, so one per-query lookup table of subspace partial
inner products replaces the Gram product (ADC;
``kernels/scan_topk.py:pq_lut`` and ``scan_topk_pq``).  The coarse scan
over-fetches and the engine rescores the candidates in f32 against the
master table, so a returned distance never comes from a code.

Training and encoding are host numpy, step for step the JAX package's,
so codes and codebooks are array-equal to JAX's for the same table and
seed; the only device-dependent step is the lift, done here on the CPU
in float32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

# int8 levels per side: symmetric, so -128 is never produced and the
# dequantized range is exactly [-max|row|, +max|row|]
QLEVELS = 127


def quantize_rows(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization: ``table`` [N, D] →
    ``(q [N, D] int8, scale [N, 1] float32)`` with ``q · scale ≈ table``
    (at most ``scale/2`` off an element).  All-zero rows get scale 0 and
    codes 0, so they dequantize to exactly 0."""
    table = np.asarray(table, np.float32)
    if table.ndim != 2:
        raise ValueError(f"table must be [N, D]; got {table.shape}")
    amax = np.max(np.abs(table), axis=1, keepdims=True)     # [N, 1]
    scale = (amax / QLEVELS).astype(np.float32)
    # guard the divide only: a zero scale still lands in the output
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(table / safe), -QLEVELS, QLEVELS).astype(np.int8)
    return q, scale


def dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``q · scale`` in f32, what the scans apply to each row."""
    return q.astype(np.float32) * np.asarray(scale, np.float32)


def quant_error_bound(scale: np.ndarray) -> float:
    """The largest reconstruction error of an element: half the worst
    row's step, ``max(scale)/2``."""
    s = np.asarray(scale, np.float32)
    return float(s.max() / 2.0) if s.size else 0.0


# int4 levels per side: nibbles in [-7, 7] (-8 is never produced)
QLEVELS4 = 7


def int4_packed_width(dim: int) -> int:
    """Packed bytes a row: two elements a byte, planar."""
    return (int(dim) + 1) // 2


def pack_int4_rows(table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int4 quantization, two nibbles a byte:
    ``table`` [N, D] → ``(packed [N, ceil(D/2)] uint8, scale [N, 1]
    float16)``.  Byte ``j`` holds element ``j`` (low nibble) and element
    ``hw + j`` (high nibble, ``hw = ceil(D/2)``; zero past D).  The scale
    is rounded to float16 first and the codes fitted against the stored
    value.  All-zero rows get scale 0 and codes 0."""
    table = np.asarray(table, np.float32)
    if table.ndim != 2:
        raise ValueError(f"table must be [N, D]; got {table.shape}")
    n, d = table.shape
    amax = np.max(np.abs(table), axis=1, keepdims=True)          # [N, 1]
    scale = (amax / QLEVELS4).astype(np.float16)                 # stored
    s32 = scale.astype(np.float32)
    safe = np.where(s32 > 0, s32, 1.0)
    q = np.clip(np.rint(table / safe), -QLEVELS4, QLEVELS4).astype(np.int8)
    hw = int4_packed_width(d)
    planar = np.zeros((n, 2 * hw), np.int8)
    planar[:, :d] = q
    lo = planar[:, :hw].astype(np.uint8) & 0xF
    hi = planar[:, hw:].astype(np.uint8) & 0xF
    return (lo | (hi << 4)).astype(np.uint8), scale


def unpack_int4_rows(packed: np.ndarray, dim: int) -> np.ndarray:
    """``packed`` [N, hw] uint8 → signed int8 codes [N, dim] (low
    nibbles first, then high)."""
    packed = np.asarray(packed, np.uint8)
    lo = (packed & 0xF).astype(np.int8)
    hi = (packed >> 4).astype(np.int8)
    lo = np.where(lo >= 8, lo - 16, lo)
    hi = np.where(hi >= 8, hi - 16, hi)
    return np.concatenate([lo, hi], axis=-1)[..., :int(dim)]


def unpack_int4_torch(packed, dim: int):
    """Tensor twin of :func:`unpack_int4_rows`: ``packed`` [..., hw]
    uint8 → signed int32 codes [..., dim] on the tensor's device."""
    import torch

    t = packed.to(torch.int32)
    lo = t & 0xF
    hi = t >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1)[..., :int(dim)]


def dequantize_int4_rows(packed: np.ndarray, scale: np.ndarray,
                         dim: int) -> np.ndarray:
    """``unpack · scale`` in f32, what the scans apply to each row."""
    codes = unpack_int4_rows(packed, dim).astype(np.float32)
    return codes * np.asarray(scale, np.float32)


def dequantize_torch(codes, scale=None, *, packed: bool = False,
                     dim: int = 0):
    """Rows of a scan lane widened to float32 on their device, as the
    scans widen them: bf16 or float32 ``codes`` [..., D] as they are;
    int8 ``codes`` times ``scale`` [..., 1]; ``packed`` int4 bytes
    [..., ceil(dim/2)] unpacked to ``dim`` nibbles times ``scale``."""
    import torch

    if packed:
        return (unpack_int4_torch(codes, dim).to(torch.float32)
                * scale.to(torch.float32))
    if scale is not None:
        return codes.to(torch.float32) * scale.to(torch.float32)
    return codes.to(torch.float32)


# --- PQ lane ------------------------------------------------------------------

PQ_VERSION = 1
# centroids per subspace — one uint8 code
PQ_CENTERS = 256


def default_pq_m(lift_dim: int) -> int:
    """Default subspace count: ~4 lifted coordinates per byte of code
    (a 10-dim poincare table lifts to 11 coordinates → m = 3)."""
    return max(1, (int(lift_dim) + 3) // 4)


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """Per-subspace centroid tables, trained in the manifold lift."""

    codebooks: np.ndarray  # [m, PQ_CENTERS, ds] f32, lifted coords
    lift_dim: int          # true lifted width (m*ds - lift_dim pad lanes)
    iters: int             # Lloyd iterations used
    seed: int              # k-means++ seeding RNG seed
    fingerprint: str       # content hash (arrays + train params)

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def ds(self) -> int:
        return int(self.codebooks.shape[2])


def pq_fingerprint_of(codebooks: np.ndarray, *, lift_dim: int, iters: int,
                      seed: int) -> str:
    """Content identity of a codebook set: sha256 over the arrays and
    the train parameters (byte-identical to the JAX package's), so
    engines decoding through different codebooks never share cached
    rows."""
    codebooks = np.ascontiguousarray(codebooks)
    h = hashlib.sha256()
    h.update(json.dumps({
        "version": PQ_VERSION, "lift_dim": int(lift_dim),
        "iters": int(iters), "seed": int(seed),
        "codebooks": [list(codebooks.shape), str(codebooks.dtype)],
    }, sort_keys=True).encode())
    h.update(codebooks.tobytes())
    return h.hexdigest()


def _sq_dists(x: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """[n, ds] × [k, ds] → [n, k] squared distances (matmul form)."""
    xx = np.einsum("nd,nd->n", x, x)[:, None]
    cc = np.einsum("kd,kd->k", cent, cent)[None, :]
    return np.maximum(xx - 2.0 * (x @ cent.T) + cc, 0.0)


def _kmeans_subspace(data: np.ndarray, rng, iters: int) -> np.ndarray:
    """256-center Euclidean k-means on one lifted subspace: k-means++
    D² seeding + fixed-iteration Lloyd (empty cells keep their seed)."""
    n = data.shape[0]
    k = PQ_CENTERS
    cent = np.empty((k, data.shape[1]), np.float32)
    cent[0] = data[int(rng.integers(n))]
    d2 = _sq_dists(data, cent[:1])[:, 0]
    for j in range(1, k):
        tot = float(d2.sum())
        if tot <= 0.0:
            # fewer distinct points than centers: duplicate uniformly
            cent[j:] = data[rng.integers(0, n, size=k - j)]
            break
        cent[j] = data[int(rng.choice(n, p=d2 / tot))]
        d2 = np.minimum(d2, _sq_dists(data, cent[j:j + 1])[:, 0])
    for _ in range(int(iters)):
        assign = np.argmin(_sq_dists(data, cent), axis=1)
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, data)
        cnt = np.bincount(assign, minlength=k)
        nz = cnt > 0
        cent[nz] = sums[nz] / cnt[nz, None]
    return cent


def pq_from_lift(lifted: np.ndarray, lift_dim: int, *, m: int,
                 iters: int = 6, seed: int = 0,
                 sample: int = 1 << 16) -> tuple[np.ndarray, PQCodebook]:
    """The numpy stage of :func:`build_pq` on already lifted rows
    ``lifted`` [N, lift_dim] f32: zero-pad to ``m*ds`` lanes, train one
    256-center k-means a subspace on a bounded ``sample``, encode every
    row in 4,096-row chunks."""
    lifted = np.asarray(lifted, np.float32)
    n, dl = lifted.shape[0], int(lift_dim)
    ds = (dl + m - 1) // m
    if m * ds > dl:
        lifted = np.concatenate(
            [lifted, np.zeros((n, m * ds - dl), np.float32)], axis=1)
    rng = np.random.default_rng(seed)
    train = lifted if n <= sample else \
        lifted[rng.choice(n, size=sample, replace=False)]
    cbs = np.stack([
        _kmeans_subspace(train[:, s * ds:(s + 1) * ds], rng, iters)
        for s in range(m)])
    codes = np.empty((n, m), np.uint8)
    chunk = 4096
    for lo in range(0, n, chunk):
        block = lifted[lo:lo + chunk]
        for s in range(m):
            codes[lo:lo + chunk, s] = np.argmin(
                _sq_dists(block[:, s * ds:(s + 1) * ds], cbs[s]),
                axis=1).astype(np.uint8)
    fp = pq_fingerprint_of(cbs, lift_dim=dl, iters=iters, seed=seed)
    return codes, PQCodebook(codebooks=cbs, lift_dim=dl, iters=int(iters),
                             seed=int(seed), fingerprint=fp)


def build_pq(table: np.ndarray, spec: tuple, *, m: int = 0,
             iters: int = 6, seed: int = 0,
             sample: int = 1 << 16) -> tuple[np.ndarray, PQCodebook]:
    """Train lifted-subspace codebooks and encode the whole table.

    ``table`` [N, D] rows on the manifold → ``(codes [N, m] uint8,
    :class:`PQCodebook`)``.  Rows are lifted as the IVF build lifts
    them (on the CPU, float32), then :func:`pq_from_lift` trains and
    encodes — deterministic in ``seed``."""
    import torch

    from hyperspace_torch.serve.index import _lift, _lift_dim

    table = np.asarray(table, np.float32)
    if table.ndim != 2:
        raise ValueError(f"table must be [N, D]; got {table.shape}")
    dl = _lift_dim(spec, table.shape[1])
    m = int(m) if m else default_pq_m(dl)
    if not 1 <= m <= dl:
        raise ValueError(f"pq m={m} must be in [1, lift_dim={dl}]")
    lifted = _lift(spec, torch.tensor(table)).numpy()
    return pq_from_lift(lifted, dl, m=m, iters=iters, seed=seed,
                        sample=sample)


def pq_decode(cb: PQCodebook, codes: np.ndarray) -> np.ndarray:
    """Host decode: codes [N, m] → lifted reconstructions [N, m*ds] f32
    (pad lanes included)."""
    codes = np.asarray(codes)
    parts = [cb.codebooks[s][codes[:, s]] for s in range(cb.m)]
    return np.concatenate(parts, axis=-1).astype(np.float32)
