"""The slab scans' selection (``kernels/csrc/scan_topk.cu``), emulated on
the CPU and held against the plain versions.

The CUDA kernels of ``scan_topk``, ``scan_topk_pq`` and
``scan_topk_cand`` share one selection machine: a warp per query keeps a
sorted list of k keys (distance bits, global column; for the candidate
scan, candidate position); candidates that pass a threshold test
are compacted into a 32-entry buffer; a full buffer (and the scan's end)
is flushed: the exact test, a bitonic sort, a merge-path merge into the
list.  The splits of a query share a threshold word, lowered by
atomicMin after a flush of a full list and reread once a tile; only
distances strictly above it are pruned.  A second kernel merges the
split lists in rounds of pairs.

This file replays that machine step by step in numpy, lane by lane
where the kernel works lane by lane (merge path, the bitonic network,
the merge rounds), with the splits advancing in seeded interleavings,
and requires its answer to equal ``scan_topk_plain`` /
``scan_topk_pq_plain`` / ``scan_topk_cand_plain`` exactly, for k 1 to
256, 1, 5 or 64 splits and distance orders that stress the ties (for
the candidate scan: -1 pads mid-list, duplicate ids, an empty query,
the query's own row, and a tie that (distance, id) keys would break).  It also holds the threshold
test's margin ε (``arg_bound``) on float32 pairs near the threshold with
log1p off by two ulp, and shows that ε = 0 fails there.

``test_flushes_at_the_smoke_shapes`` prints the emulated flushes and
buffered candidates per warp-split at ``chip_smoke.py``'s serving shapes
(``-s`` shows them).
"""

import json
import math
import zlib

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels import scan_topk as T
from hyperspace_torch.manifolds import PoincareBall
from hyperspace_torch.manifolds.maps import ball_to_lorentz

EMPTY = (0x7F800000 << 32) | 0xFFFFFFFF          # (+inf, -1)
INF_BITS = 0x7F800000
F32 = np.float32


def seeded(*parts) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def key(d: float, col: int) -> int:
    return (int(np.array(d, F32).view(np.uint32)) << 32) | (col & 0xFFFFFFFF)


def key_dist(x: int) -> float:
    return float(np.array(x >> 32, np.uint32).view(F32))


# --- the kernel's pieces, lane by lane -------------------------------------


def merge_path(a, na, b, nb, diag):
    lo, hi = max(0, diag - nb), min(diag, na)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def merge_list(a, k, b, nb):
    """merge_list: 32 lanes, each writing ceil(k/32) outputs from its
    own merge-path split; outputs staged, then written."""
    p = (k + 31) >> 5
    out = list(a)
    for lane in range(32):
        diag = min(lane * p, k)
        i = merge_path(a, k, b, nb, diag)
        j = diag - i
        for t in range(p):
            if diag + t >= k:
                break
            ta = j >= nb or a[i] <= b[j]
            out[diag + t] = a[i] if ta else b[j]
            i, j = (i + 1, j) if ta else (i, j + 1)
    return out


def sort32(x):
    """The bitonic network of sort32, one key a lane."""
    x = list(x)
    size = 2
    while size <= 32:
        stride = size >> 1
        while stride > 0:
            y = [x[lane ^ stride] for lane in range(32)]
            keep_min = [((ln & size) == 0) == ((ln & stride) == 0)
                        for ln in range(32)]
            x = [min(x[ln], y[ln]) if keep_min[ln] else max(x[ln], y[ln])
                 for ln in range(32)]
            stride >>= 1
        size <<= 1
    return x


def merge_tree(lists, k):
    """merge_tree_kernel's rounds: pairs merged by merge path with
    32/pairs lanes a pair, an odd list carried."""
    src = [list(x) for x in lists]
    while len(src) > 1:
        pairs = len(src) // 2
        g = 1 if pairs >= 32 else 32 // pairs
        dst = []
        for pp in range(pairs):
            a, b = src[2 * pp], src[2 * pp + 1]
            o = [None] * k
            per = (k + g - 1) // g
            for gl in range(g):
                diag = min(gl * per, k)
                end = min(diag + per, k)
                i = merge_path(a, k, b, k, diag)
                j = diag - i
                for oo in range(diag, end):
                    ta = j >= k or a[i] <= b[j]
                    o[oo] = a[i] if ta else b[j]
                    i, j = (i + 1, j) if ta else (i, j + 1)
            dst.append(o)
        if len(src) & 1:
            dst.append(src[-1])
        src = dst
    return src[0]


class Warp:
    """One warp-split of a slab scan: its list, buffer and threshold."""

    def __init__(self, k, word):
        self.k, self.word = k, word          # word: a one-element list
        self.list = [EMPTY] * k
        self.buf = []                        # (d, col) in lane order
        self.seen = math.inf if word is None else math.inf
        self.t = math.inf
        self.flushes = self.buffered = 0

    def kth(self):
        return key_dist(self.list[-1])

    def retarget(self):
        self.t = min(self.kth(), self.seen)

    def reread(self):
        if self.word is not None:
            w = float(np.array(self.word[0], np.uint32).view(F32))
            if w < self.seen:
                self.seen = w
                self.retarget()

    def flush(self):
        self.flushes += 1
        keys = [EMPTY] * 32
        for lane, (d, col) in enumerate(self.buf):
            if d < self.kth() and d <= self.seen:
                keys[lane] = key(d, col)
        self.buf = []
        live = sum(x != EMPTY for x in keys)
        if not live:
            return
        self.list = merge_list(self.list, self.k, sort32(keys), live)
        kd = self.kth()
        if self.word is not None and kd < self.seen:
            old = float(np.array(self.word[0], np.uint32).view(F32))
            self.word[0] = min(self.word[0],
                               int(np.array(kd, F32).view(np.uint32)))
            self.seen = min(kd, old)
        self.retarget()

    def step(self, d, cols, valid):
        """One step: lane l offers row cols[l] at distance d[l]."""
        hit = np.flatnonzero(valid & (d <= self.t))
        for ln in hit:                       # ballot order = lane order
            self.buf.append((float(d[ln]), int(cols[ln])))
            self.buffered += 1
            if len(self.buf) == 32:
                self.flush()

    def finish(self):
        if self.buf:
            self.flush()


def emulate(dmat, col0, k, splits, order_seed, tile=64, cols=None):
    """The kernels' answer for a masked distance matrix ``dmat`` [B, M]
    (float32, +inf = masked): per query, ``splits`` warp-splits share a
    threshold word and advance one step at a time in the order that
    ``order_seed`` draws ("seq" = split by split, last first).  Keys
    take column ``col0 + j`` at place j, or ``cols[b, j]`` when given."""
    b, m = dmat.shape
    rps = -(-m // splits)
    out_d = np.empty((b, k), F32)
    out_i = np.empty((b, k), np.int32)
    stats = []
    for qb in range(b):
        word = [INF_BITS] if splits > 1 else None
        warps = [Warp(k, word) for _ in range(splits)]
        pos = [s * rps for s in range(splits)]
        ends = [min(m, (s + 1) * rps) for s in range(splits)]
        rng = np.random.default_rng(order_seed) if order_seed != "seq" \
            else None
        live = [s for s in range(splits) if pos[s] < ends[s]]
        while live:
            s = live[-1] if rng is None else live[rng.integers(len(live))]
            w, lo = warps[s], pos[s]
            if (lo - s * rps) % tile == 0:
                w.reread()
            hi = min(lo + 32, ends[s], s * rps + ((lo - s * rps) // tile + 1)
                     * tile)
            d = dmat[qb, lo:hi]
            w.step(d, col0 + np.arange(lo, hi) if cols is None
                   else cols[qb, lo:hi], np.isfinite(d))
            pos[s] = hi
            if hi >= ends[s]:
                w.finish()
                live.remove(s)
        for w in warps:
            stats.append((w.flushes, w.buffered))
        res = merge_tree([w.list for w in warps], k) if splits > 1 \
            else warps[0].list
        out_d[qb] = [key_dist(x) for x in res]
        out_i[qb] = [np.int32(np.uint32(x & 0xFFFFFFFF)) for x in res]
    return out_d, out_i, stats


def full_matrix(plain, m, col0, **kw):
    """The masked distance matrix the plain version sorts, read back
    from a full-width plain answer."""
    d, i = plain(k=m, **kw)
    dm = np.full((d.shape[0], m), np.inf, F32)
    fin = torch.isfinite(d).numpy()
    rows, slots = np.nonzero(fin)
    dm[rows, i.numpy()[rows, slots] - col0] = d.numpy()[rows, slots]
    return dm


# --- the selection against the plain versions -----------------------------


ORDERS = ("random", "ascending", "descending", "all_equal", "equal_blocks")
KS = (1, 10, 31, 32, 33, 170, 256)
SPLITS = (1, 5, 64)


def pq_case(order, m=2300, b=3):
    """Euclidean ADC with m = 2 subspaces whose lookup tables make the
    row score v·2^-10, v = 256·code0 + code1, exactly: the codes lay out
    the distance order along the slab."""
    rng = seeded("pq", order)
    if order == "random":
        v = rng.permutation(m)
    elif order == "ascending":
        v = np.arange(m)
    elif order == "descending":
        v = m - 1 - np.arange(m)
    elif order == "all_equal":
        v = np.full(m, 777)
    else:                                  # blocks of 37 equal keys
        v = rng.permutation(-(-m // 37))[np.arange(m) // 37]
    codes = torch.as_tensor(np.stack([v // 256, v % 256], 1),
                            dtype=torch.uint8)
    lut = np.zeros((b, 512), F32)
    lut[:, :256] = np.arange(256) * 256 * 2.0 ** -10
    lut[:, 256:] = np.arange(256) * 2.0 ** -10
    return codes, torch.as_tensor(lut)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("order", ORDERS)
def test_selection_equals_plain_pq(order, k, splits):
    codes, lut = pq_case(order)
    m = codes.shape[0]
    col0, n = 5, 5 + m - 37                   # the last 37 rows masked
    qi = torch.as_tensor([9, 5 + m // 2, 5 + 1234], dtype=torch.int32)
    kw = dict(kind="euclidean", c=0.0, n=n, exclude_self=True)
    want_d, want_i = T.scan_topk_pq_plain(codes, lut, qi, col0, k=k, **kw)
    dm = full_matrix(lambda k, **a: T.scan_topk_pq_plain(codes, lut, qi, col0,
                                                         k=k, **a),
                     m, col0, **kw)
    for interleaving in (zlib.crc32(f"{order}{k}{splits}".encode()), "seq"):
        got_d, got_i, _ = emulate(dm, col0, k, splits, interleaving)
        assert np.array_equal(got_d, want_d.numpy(), equal_nan=False)
        assert np.array_equal(got_i, want_i.numpy())
    if order == "all_equal":               # the lowest k columns
        reach = [c for c in range(col0, n)]
        for qb in range(3):
            cols = [c for c in reach if c != int(qi[qb])][:k]
            assert got_i[qb, :len(cols)].tolist() == cols


def dense_rows(rng, n, d, kind):
    if kind == "euclidean":
        return torch.as_tensor(rng.standard_normal((n, d)) * 0.5,
                               dtype=torch.float32)
    x = PoincareBall(1.0).expmap0(torch.as_tensor(
        rng.standard_normal((n, d)) * 0.4, dtype=torch.float32))
    return ball_to_lorentz(x, 1.0) if kind == "lorentz" else x


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ("poincare", "lorentz", "euclidean"))
def test_selection_equals_plain_dense(kind, k, splits):
    """Random order: table rows of the three families; queries on the
    table (exact duplicates of rows, ties at d = 0) and off it."""
    rng = seeded("dense", kind, k, splits)
    m = 2200
    slab = dense_rows(rng, m, 10, kind)
    slab[700:740] = slab[300]                 # forty equal rows
    q = torch.cat([slab[[300, 5]], dense_rows(rng, 2, 10, kind)])
    qi = torch.as_tensor([300 + 11, 5 + 11, 0, 1], dtype=torch.int32)
    spec_c = 0.0 if kind == "euclidean" else 1.0
    for ex, col0, n in ((True, 11, 11 + m - 29), (False, 0, m)):
        kw = dict(kind=kind, c=spec_c, n=n, exclude_self=ex)
        want_d, want_i = T.scan_topk_plain(slab, q, qi, col0, k=k, **kw)
        dm = full_matrix(lambda k, **a: T.scan_topk_plain(slab, q, qi, col0,
                                                          k=k, **a),
                         m, col0, **kw)
        got_d, got_i, _ = emulate(dm, col0, k, splits,
                                  zlib.crc32(f"{kind}{k}{splits}".encode()))
        assert np.array_equal(got_d, want_d.numpy())
        assert np.array_equal(got_i, want_i.numpy())


# the candidate scan: keys (distance, candidate position), 32·R positions
# a step (csrc/scan_topk.cu CAND_ROWS), the word reread at each step
CAND_STEP = 32 * T._CAND_ROWS


def cand_case(kind, seed):
    """A table (ids 700–704 copies of row 300), 6 queries (the first two
    on row 300) and their candidate lists of 2,300 positions: -1 pads in
    a mid-list run and scattered, duplicate ids (positions 500–519
    repeat 0–19), a tied pair whose lower id sits at the later position
    (row 1: 704 at position 10, 300 at 2,000), an empty query (row 3)."""
    rng = seeded("cand", kind, seed)
    n, c = 3000, 2300
    table = dense_rows(rng, n, 10, kind)
    table[700:705] = table[300]
    q = torch.cat([table[[300, 300]], dense_rows(rng, 4, 10, kind)])
    cand = rng.integers(0, n, (6, c))
    cand[:, 100:140] = -1
    cand[rng.random((6, c)) < 0.2] = -1
    cand[:, 500:520] = cand[:, 0:20]
    cand[1, 10], cand[1, 2000] = 704, 300
    cand[0, 7] = 300                         # the query's own row
    cand[3] = -1
    qi = torch.as_tensor([300, 5, 0, 1, 2, 3], dtype=torch.int32)
    return table, torch.as_tensor(cand, dtype=torch.int32), q, qi


def cand_emulate(table, cand, q, qi, kind, k, splits, ex, order, keys):
    """The candidate scan's answer: the masked distances of the plain
    version, selected by the emulated machine with keys (distance,
    position), positions then read back as ids; ``keys="id"`` keys on
    the ids instead."""
    c = 0.0 if kind == "euclidean" else 1.0
    dm = T._cand_masked_dist(table, cand, q, qi, kind=kind, c=c,
                             exclude_self=ex).numpy().astype(F32)
    ids = cand.numpy()
    got_d, got_p, _ = emulate(dm, 0, k, splits, order, tile=CAND_STEP,
                              cols=ids if keys == "id" else None)
    if keys == "id":
        return got_d, got_p
    rows = np.arange(len(ids))[:, None]
    return got_d, np.where(got_p >= 0, ids[rows, np.maximum(got_p, 0)], -1)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ("poincare", "lorentz", "euclidean"))
def test_cand_selection_equals_plain(kind, k, splits):
    table, cand, q, qi = cand_case(kind, 0)
    c = 0.0 if kind == "euclidean" else 1.0
    for ex in (True, False):
        want_d, want_i = T.scan_topk_cand_plain(table, cand, q, qi,
                                                kind=kind, c=c, k=k,
                                                exclude_self=ex)
        for order in (zlib.crc32(f"{kind}{k}{splits}{ex}".encode()), "seq"):
            got_d, got_i = cand_emulate(table, cand, q, qi, kind, k, splits,
                                        ex, order, "position")
            assert np.array_equal(got_d, want_d.numpy())
            assert np.array_equal(got_i, want_i.numpy())
        assert np.all(got_i[3] == -1) and np.all(np.isinf(got_d[3]))
        if ex:
            assert not np.any(got_i[0] == 300)


def test_cand_id_keys_break_the_tie_rule():
    """Row 1 of the case ties ids 704 (position 10) and 300 (position
    2,000) at one distance: the plain version lists 704 first, as
    position keys do; (distance, id) keys would list 300 first."""
    kind, k, splits = "poincare", 256, 5
    table, cand, q, qi = cand_case(kind, 0)
    want_d, want_i = T.scan_topk_cand_plain(table, cand, q, qi,
                                            kind=kind, c=1.0, k=k,
                                            exclude_self=True)
    got = cand_emulate(table, cand, q, qi, kind, k, splits, True, 7,
                       "position")
    assert np.array_equal(got[1], want_i.numpy())
    row = want_i[1].tolist()
    assert row.index(704) < row.index(300)
    by_id = cand_emulate(table, cand, q, qi, kind, k, splits, True, 7, "id")
    assert not np.array_equal(by_id[1], want_i.numpy())
    assert by_id[1][1].tolist().index(300) < by_id[1][1].tolist().index(704)


def test_merge_pieces_agree_with_a_sort():
    """The bitonic network sorts; merge_list and merge_tree keep the k
    smallest keys, EMPTY padding included."""
    rng = seeded("pieces")
    for _ in range(50):
        x = [int(v) for v in rng.integers(0, 2 ** 40, 32)]
        x[rng.integers(32)] = EMPTY
        assert sort32(x) == sorted(x)
        k = int(rng.integers(1, 257))
        a = sorted(int(v) for v in rng.integers(0, 2 ** 40, k))
        nb = int(rng.integers(1, 33))
        b = sorted(int(v) for v in rng.integers(0, 2 ** 40, nb))
        assert merge_list(a, k, b + [EMPTY] * (32 - nb), nb) == \
            sorted(a + b)[:k]
        lists = [sorted(int(v) for v in rng.integers(0, 2 ** 40, k))
                 for _ in range(int(rng.integers(2, 65)))]
        assert merge_tree(lists, k) == sorted(sum(lists, []))[:k]


# --- the threshold test's margin ------------------------------------------

EPS_D = 16.0 * 2.0 ** -24
EPS_Q = 2.0 ** -22
FLOOR = 2.0 ** -96


def nudge(x, ulps):
    """x >= 0 moved by ``ulps`` units in the last place (not below 0)."""
    bits = np.asarray(x, F32).view(np.int32).astype(np.int64) + ulps
    return np.maximum(bits, 0).astype(np.int32).view(F32)


def dist_of(u, sc, log1p_ulps):
    """arcosh1p(u)/sc in float32 as the kernel computes it, log1pf
    replaced by the correctly rounded log1p moved by ``log1p_ulps``."""
    u = np.asarray(u, F32)
    t = u * (u + F32(2.0))
    a = u + np.sqrt(np.maximum(t, F32(0.0)))
    lg = nudge(np.log1p(a.astype(np.float64)).astype(F32), log1p_ulps)
    return (lg / F32(sc)).astype(F32)


def arg_bound(t, sc, eps_d=EPS_D, eps_q=EPS_Q):
    """The kernel's arg_bound for a hyperbolic kind, in float64 rounded
    up to float32."""
    if not t < np.inf:
        return F32(np.inf)
    s = math.sinh(0.5 * float(sc) * float(t) * (1.0 + eps_d))
    v = 2.0 * s * s * (1.0 + eps_q)
    f = F32(v)
    if float(f) < v:
        f = np.nextafter(f, F32(np.inf))
    return max(f, F32(FLOOR))


def margin_violations(eps_d, eps_q):
    """Candidates u whose distance, with log1p off by ±2 ulp, is <= a
    threshold T while u exceeds arg_bound(T): near T (each T the
    distance of a float u0, u within ±40 ulp of the bound)."""
    rng = seeded("margin")
    bad = 0
    for sc in (1.0, 0.7071067690849304, 1.5165750980377197):
        for u0 in np.concatenate([10.0 ** rng.uniform(-12, 3, 300),
                                  [1e-30, 2.0 ** -120]]).astype(F32):
            for shift in (-2, 0, 2):
                t = dist_of(u0, sc, shift)
                ub = arg_bound(t, sc, eps_d, eps_q)
                us = nudge(np.full(81, ub, F32), np.arange(-40, 41))
                for s2 in (-2, 2):
                    ok = dist_of(us, sc, s2) <= t
                    bad += int(np.sum(ok & (us > ub)))
    return bad


def test_arg_bound_margin_covers_log1p_two_ulp_off():
    assert margin_violations(EPS_D, EPS_Q) == 0


def test_arg_bound_without_margin_fails():
    assert margin_violations(0.0, 0.0) > 0


def test_ball_quotient_multiply_compare_is_conservative():
    """fl(num/den) <= U implies num <= fl(U·den): the ball's test needs
    no division, because U carries EPS_Q."""
    rng = seeded("quotient")
    num = (10.0 ** rng.uniform(-20, 2, 20000)).astype(F32)
    den = np.maximum((10.0 ** rng.uniform(-8, 0, 20000)).astype(F32),
                     F32(1e-7))
    u = (num / den).astype(F32)
    for t in np.concatenate([u[:2000], (u * F32(0.999999))[:2000]]):
        ub = arg_bound(dist_of(t, 1.0, 0), 1.0)
        ok_u = u <= ub
        assert np.all(~ok_u | (num <= (ub * den).astype(F32)))


def test_euclidean_threshold_is_exact():
    """The largest float x with sqrt(x) <= T, as arg_bound finds it."""
    rng = seeded("euclid")
    for t in (10.0 ** rng.uniform(-20, 18, 2000)).astype(F32):
        x = F32(np.float64(t) * np.float64(t))
        if float(x) < float(t) * float(t):
            x = np.nextafter(x, F32(np.inf))     # __fmul_ru
        while x > 0 and np.sqrt(x) > t:
            x = np.nextafter(x, F32(0))
        while np.sqrt(np.nextafter(x, F32(np.inf))) <= t:
            x = np.nextafter(x, F32(np.inf))
        assert np.sqrt(x) <= t < np.sqrt(np.nextafter(x, F32(np.inf)))


# --- what the emulation says about the smoke's shapes ------------------------


def test_flushes_at_the_smoke_shapes():
    """Flushes and buffered candidates per warp-split at the serving
    shapes of chip_smoke.py: the dense scan over 83,968 slab rows
    (82,115 real, 10-dim ball rows drawn as the smoke draws them) at
    k = 10, and the ADC scan at its k = 170 over random m = 3 codes,
    with 5 splits (bucket 1024) and 64 (bucket 8); a sample of queries,
    splits interleaved at random.  Printed as JSON lines."""
    rng = seeded("smoke shapes")
    rows, padded, nq = 82115, 83968, 4
    table = PoincareBall(1.0).expmap0(torch.as_tensor(
        rng.standard_normal((rows, 10)) * 0.5, dtype=torch.float32))
    slab = torch.zeros((padded, 10))
    slab[:rows] = table
    q = PoincareBall(1.0).expmap0(torch.as_tensor(
        rng.standard_normal((nq, 10)) * 0.5, dtype=torch.float32))
    qi = torch.as_tensor(rng.integers(0, rows, nq), dtype=torch.int32)
    kw = dict(kind="poincare", c=1.0, n=rows, exclude_self=True)
    d = T._dist_plain("poincare", 1.0, q, slab).numpy().astype(F32)
    d[:, rows:] = np.inf
    d[np.arange(nq), qi.numpy()] = np.inf
    codes = torch.as_tensor(rng.integers(0, 256, (padded, 3)),
                            dtype=torch.uint8)
    lut = torch.as_tensor(-1.0 - rng.random((nq, 768)) * 0.3,
                          dtype=torch.float32)
    dpq = T._pq_dist_from_sum(
        "poincare", 1.0,
        sum(lut[:, s * 256 + codes[:, s].long()] for s in range(3))
    ).numpy().astype(F32)
    dpq[:, rows:] = np.inf
    dpq[np.arange(nq), qi.numpy()] = np.inf
    for name, dm, k in (("scan_topk", d, 10), ("scan_topk_pq", dpq, 170)):
        for splits in (5, 64):
            got_d, got_i, stats = emulate(dm, 0, k, splits, 7, tile=256)
            if name == "scan_topk":
                want_d, want_i = T.scan_topk_plain(slab, q, qi, 0, k=k, **kw)
                assert np.array_equal(got_d, want_d.numpy())
                assert np.array_equal(got_i, want_i.numpy())
            st = np.asarray(stats, np.float64)
            rec = {"kernel": name, "k": k, "splits": splits,
                   "rows_per_split": -(-padded // splits),
                   "flushes_per_warp_split": float(st[:, 0].mean()),
                   "buffered_per_warp_split": float(st[:, 1].mean()),
                   "queries": nq}
            print(json.dumps(rec))
            # the shared word keeps each split's work near k·(1 + ln)
            assert rec["buffered_per_warp_split"] < 4 * k * (
                1 + math.log(rec["rows_per_split"] / k))
