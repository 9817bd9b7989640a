"""The work split of the streaming segment kernels
(``kernels/csrc/segment.cu``: ``segsum_kernel`` and ``att_edges_kernel``),
emulated on the CPU and held against the plain version.

Both kernels cut the receiver-sorted edges into equal spans of whole
chunks, one span a block.  A block streams its span chunk by chunk
(t edges, about ``TILE_BYTES`` of values), owns every row whose first
edge lies in its span, skips the leading edges of an earlier block's
row, carries a row that runs into the next chunk, and walks on past its
span until its last row ends.  The edge after a gap of receivers marks
the empty rows between for its block; the fill blocks at the grid's end
write the rows below the first receiver and above the last.  A chunk's
values are copied as one span: 16-byte copies of its aligned middle and
element copies of the head and tail.

This file replays that rule in numpy, reading the constants from the
CUDA source, and asserts on hazard inputs (hub rows over many chunks,
rows ending at chunk ends, long runs of empty rows, no edge, unaligned
pitches and views) that every row is written exactly once, every edge is
summed exactly once, the sums equal ``csr_segment_sum_plain``'s within
the f32 tier, and every span copy reads exactly its bytes.
"""

import os
import re
import zlib

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels.segment import csr_segment_sum_plain

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "hyperspace_torch",
                   "kernels", "csrc", "segment.cu")
NO_ROW = 2 ** 31 - 1


def _constants() -> dict:
    with open(SRC) as fh:
        src = fh.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("TILE_BYTES", "ATT_TILE_BYTES", "TILE_MAX",
                      "FILL_ROWS")}


C = _constants()


def chunk_edges(rowb: int, tile: str = "TILE_BYTES") -> int:
    """Edges a chunk of B1 (``TILE_BYTES``) or B5 (``ATT_TILE_BYTES``)."""
    return max(1, min(C[tile] // rowb, C["TILE_MAX"]))


def span_copy(addr: int, nbytes: int, size: int):
    """The reads of one staged span [addr, addr + nbytes): element copies
    of the head and tail, 16-byte copies of the aligned middle."""
    o = addr % 16
    hb = min((16 - o) % 16, nbytes)
    nch = (nbytes - hb) // 16
    tail = hb + 16 * nch
    reads = [(addr + i, size) for i in range(0, hb, size)]
    reads += [(addr + hb + 16 * c, 16) for c in range(nch)]
    reads += [(addr + i, size) for i in range(tail, nbytes, size)]
    return reads


def check_span(addr: int, nbytes: int, size: int) -> None:
    got = np.zeros(nbytes, np.int64)
    for a, ln in span_copy(addr, nbytes, size):
        assert addr <= a and a + ln <= addr + nbytes, "a read leaves the span"
        if ln == 16:
            assert a % 16 == 0, "a 16-byte copy is not aligned"
        got[a - addr:a - addr + ln] += 1
    assert np.all(got == 1), "the span's bytes are not each read once"


def emulate(recv: np.ndarray, n: int, f: int, size: int, resident: int,
            base: int, vals: np.ndarray, tile: str = "TILE_BYTES"):
    """The kernel's split on these edges: (writes a row, uses an edge,
    the f32 sums in the kernel's order)."""
    e = len(recv)
    t = chunk_edges(f * size, tile)
    chunks = -(-e // t)
    per_blk = max(1, -(-chunks // max(1, resident)))
    span = per_blk * t
    nblk = -(-e // span) if e else 0
    writes = np.zeros(n, np.int64)
    used = np.zeros(e, np.int64)
    out = np.zeros((n, f), np.float32)
    keys = np.concatenate([[-1], recv, [NO_ROW] * (t + 2)]).astype(np.int64)

    def row_sum(edges, acc):
        acc = acc.copy()
        for i in edges:
            acc += vals[i]
            used[i] += 1
        return acc

    for b in range(nblk):
        s_lo, s_hi = b * span, min(b * span + span, e)
        is_open, okey, carry, p = False, -1, None, s_lo
        while True:
            kw = keys[p:p + t + 2]          # key of edge p - 1 + i
            cn = min(t, e - p)
            check_span(base + p * f * size, cn * f * size, size)
            walk = p >= s_hi
            last = kw[cn] == okey if walk else (is_open or kw[cn] != kw[0])
            cont = bool(last and cn == t and p + t < e
                        and kw[cn + 1] == kw[cn])
            nxt = p + t < s_hi or cont
            if walk:
                seg = [0, int(np.sum(kw[1:cn + 1] == okey))]
                first = 0
            else:
                heads = [i for i in range(cn) if kw[i + 1] != kw[i]]
                seg = ([0] if is_open else []) + heads + [cn]
                first = 1 if is_open else 0
                for s in range(first, len(seg) - 1):     # gaps
                    prev, hi = int(kw[seg[s]]), min(int(kw[seg[s] + 1]), n)
                    if prev >= 0 and hi > prev + 1:
                        writes[prev + 1:hi] += 1
            ns = len(seg) - 1
            new_carry = None
            for s in range(ns):
                a, bb = seg[s], seg[s + 1]
                # in edge order after the carried part, as the kernel sums
                acc = row_sum(range(p + a, p + bb),
                              carry if s == 0 and is_open
                              else np.zeros(f, np.float32))
                if s == ns - 1 and cont:
                    new_carry = acc
                else:
                    row = int(kw[a + 1])
                    writes[row] += 1
                    out[row] = acc
            carry, is_open, okey = new_carry, cont, int(kw[cn])
            if not nxt:
                break
            p += t
    first = recv[0] if e else n
    last = recv[-1] if e else n
    for fb in range(-(-n // C["FILL_ROWS"])):
        r0 = fb * C["FILL_ROWS"]
        r1 = min(r0 + C["FILL_ROWS"], n)
        writes[r0:min(r1, first)] += 1
        writes[max(r0, last + 1):r1] += 1
    return writes, used, out


def seeded(*parts) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def hazard_edges(kind: str, n: int, e: int, f: int, size: int, rng,
                 tile: str = "TILE_BYTES"):
    t = chunk_edges(f * size, tile)
    if kind == "random":
        r = rng.integers(0, n, e)
    elif kind == "hub":             # one row over many chunks
        r = np.where(rng.random(e) < 0.7, n // 2, rng.integers(0, n, e))
    elif kind == "chunk_ends":      # rows ending exactly at chunk ends
        r = np.repeat(np.arange(e // t + 1), t)[:e] * 3
    elif kind == "sparse":          # long runs of empty rows
        r = rng.choice(n, e, replace=False)
    elif kind == "short":           # receivers stop short of the last row
        r = rng.integers(0, min(n, 500), e)
    elif kind == "one_row":
        r = np.full(e, n - 1)
    else:
        r = np.zeros(0, np.int64)
    return np.sort(r).astype(np.int32)


CASES = [
    # kind, n, e, f, dtype bytes, resident blocks, base misalignment
    ("random", 300, 2000, 17, 4, 8, 0),
    ("random", 2000, 20000, 33, 2, 132, 2),
    ("random", 1000, 5000, 129, 2, 16, 6),
    ("random", 1000, 9000, 32, 2, 528, 0),
    ("hub", 300, 30000, 128, 2, 8, 0),
    ("hub", 300, 12000, 33, 4, 64, 4),
    ("chunk_ends", 9000, 6000, 128, 2, 4, 0),
    ("chunk_ends", 9000, 6000, 32, 2, 3, 0),
    ("sparse", 169343, 3000, 128, 2, 528, 0),
    ("sparse", 169343, 4000, 33, 2, 132, 2),
    ("short", 169343, 5000, 129, 2, 64, 10),
    ("one_row", 90, 5000, 7, 4, 16, 4),
    ("none", 64, 0, 8, 2, 528, 0),
    ("random", 7, 3, 5, 4, 528, 0),
]
# B5's chunks (its own chunk size) over the same hazards
CASES_B5 = [
    ("random", 2000, 20000, 129, 2, 132, 2),
    ("hub", 300, 30000, 128, 2, 8, 0),
    ("chunk_ends", 9000, 6000, 32, 2, 3, 0),
    ("sparse", 169343, 3000, 128, 4, 528, 4),
]
ALL = ([c + ("TILE_BYTES",) for c in CASES]
       + [c + ("ATT_TILE_BYTES",) for c in CASES_B5])


@pytest.mark.parametrize("kind,n,e,f,size,resident,base,tile", ALL,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-F{c[3]}-{c[4]}B"
                              f"-res{c[5]}-off{c[6]}"
                              + ("-B5" if c[7] != "TILE_BYTES" else "")
                              for c in ALL])
def test_split_writes_each_row_once_and_sums_each_edge_once(
        kind, n, e, f, size, resident, base, tile):
    rng = seeded(kind, n, e, f, size, resident, base)
    recv = hazard_edges(kind, n, e, f, size, rng, tile)
    vals = rng.standard_normal((len(recv), f)).astype(np.float32)
    writes, used, out = emulate(recv, n, f, size, resident, base, vals,
                                tile)
    assert np.all(writes == 1), (
        f"rows written {np.bincount(writes)} times (index = count)")
    assert np.all(used == 1), "an edge summed other than once"
    want = csr_segment_sum_plain(torch.from_numpy(vals),
                                 torch.from_numpy(recv), n).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("f", [1, 7, 32, 33, 128, 129])
def test_span_copies_read_exactly_the_span(f, size):
    """Chunk spans at every alignment a view can give, and the B5 spans
    (f + 1 floats of d_num | d_den rows, w and lm)."""
    for base in range(0, 16, size):
        b4 = base - base % 4                    # a float array's alignment
        for p in (0, 1, 3, 5, 17):
            for cn in (0, 1, 2, 9, chunk_edges(f * size)):
                check_span(base + p * f * size, cn * f * size, size)
                check_span(b4 + p * (f + 1) * 4, cn * (f + 1) * 4, 4)
                check_span(b4 + p * 4, cn * 4, 4)


# --- the shapes the split meets on the HGCN step ---------------------------


def _step_shapes(use_att: bool) -> dict:
    """(F, dtype, edge set) of every csr_segment_sum call in one HGCN
    link-prediction step of the bench's path (bf16 lanes), on a small
    arxiv-like split with its cluster split, on the CPU."""
    import collections
    import sys

    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels import segment as KS
    from hyperspace_torch.kernels.cluster import build_cluster_split

    nodes = 6000
    split, _ = B.arxiv_scale_split(nodes, seed=0)
    g = split.graph
    g.cluster_split = build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, nodes,
        min_pair_edges=G.cluster_min_pair_for(use_att), rev_perm=g.rev_perm)
    s = B.setup_lp(device="cpu", split=split, seed=0, use_att=use_att)
    sets = {len(s.ga.cluster.s_recv): "stragglers", len(s.pos.u): "pairs"}
    calls = collections.Counter()
    orig = KS.csr_segment_sum

    def spy(values, receivers, plan, n):
        calls[(values.shape[1], str(values.dtype)[6:],
               sets[receivers.shape[0]])] += 1
        return orig(values, receivers, plan, n)

    mods = [m for name, m in sys.modules.items()
            if name.startswith("hyperspace_torch")
            and getattr(m, "csr_segment_sum", None) is orig]
    try:
        for m in mods:
            m.csr_segment_sum = spy
        neg = torch.randint(0, nodes, s.neg_u.shape,
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32)
        s.step(neg)
    finally:
        for m in mods:
            m.csr_segment_sum = orig
    return dict(calls)


@pytest.mark.parametrize("use_att", [False, True], ids=["mean", "attention"])
def test_hgcn_step_segment_sum_shapes(use_att):
    """The 7 launches of a step by width: the mean arm's two layers
    forward and backward on the straggler edges (F = 128, 32) and the
    decoder's three endpoint scatters (F = 33); the attention arm's
    (num | den) forwards (F + 1 = 129, 33) and dh backwards (128, 32)."""
    want = ({(128, "bfloat16", "stragglers"): 2,
             (32, "bfloat16", "stragglers"): 2,
             (33, "bfloat16", "pairs"): 3} if not use_att else
            {(129, "bfloat16", "stragglers"): 1,
             (128, "bfloat16", "stragglers"): 1,
             (33, "bfloat16", "stragglers"): 1,
             (32, "bfloat16", "stragglers"): 1,
             (33, "bfloat16", "pairs"): 3})
    assert _step_shapes(use_att) == want
