"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This module
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: float32 distances rtol 1e-5, atol 1e-4 (the kernel and the
plain version sum in different orders); ids equal outside runs of
near-ties.  Queries are never table rows here: at d = 0 the Gram form's
rounding noise differs between the two.  The scatter kernels: float32
rtol = atol = 1e-5 (sums in another order); bf16 within one bf16 ulp of
the plain version's result (both sum in f32 and round once).  The
attention arm's kernels: within 2·k·2^-24 of each output's absolute
term sum for a sum of k terms (another order), plus one f32 ulp of each
weight, and one bf16 ulp of each weight (2^-7 of it) where the weights
are rounded to bf16; a max exactly.  The HyboNet kernels' tolerances stand above
their tests.
"""

import copy

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels._support import topk_disagreements
from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                              cluster_aggregate_plain,
                                              cluster_att_bwd,
                                              cluster_att_bwd_plain,
                                              cluster_att_fwd,
                                              cluster_att_fwd_plain)
from hyperspace_torch.kernels.distmat import pdist, pdist_plain
from hyperspace_torch.kernels.segment import (csr_att_bwd_edges,
                                              csr_att_bwd_edges_plain,
                                              csr_segment_reduce_1d,
                                              csr_segment_reduce_1d_plain,
                                              csr_segment_sum,
                                              csr_segment_sum_plain)
from hyperspace_torch.kernels.scan_topk import (pq_lut, scan_topk,
                                                scan_topk_cand,
                                                scan_topk_cand_plain,
                                                scan_topk_plain,
                                                scan_topk_pq,
                                                scan_topk_pq_plain)
from hyperspace_torch.manifolds.maps import ball_to_lorentz
from hyperspace_torch.serve.engine import QueryEngine

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rows(rng, n, d, kind, dev, c=1.0):
    if kind == "euclidean":
        return torch.as_tensor(rng.standard_normal((n, d)),
                               dtype=torch.float32, device=dev)
    dd = d - 1 if kind == "lorentz" else d
    v = rng.standard_normal((n, dd))
    v *= rng.uniform(0.0, 0.9, (n, 1)) / np.linalg.norm(v, axis=1,
                                                        keepdims=True)
    x = torch.as_tensor(v / np.sqrt(c), dtype=torch.float32, device=dev)
    return ball_to_lorentz(x, c).contiguous() if kind == "lorentz" else x


@pytest.mark.parametrize("kind,d,n,m,c", [
    pytest.param("poincare", 3, 37, 301, 1.0, id="poincare-3"),
    pytest.param("poincare", 10, 37, 301, 1.0, id="poincare-10"),
    pytest.param("poincare", 40, 37, 301, 1.0, id="poincare-40"),
    pytest.param("lorentz", 11, 37, 301, 1.0, id="lorentz-11"),
    # the served shapes: one query, bucket 8, a two-stage chunk, the IVF
    # centroids (m % 4 = 3: rows start off 16-byte boundaries), m % 4 = 2
    ("poincare", 10, 1, 2048, 1.0), ("poincare", 10, 8, 2048, 1.0),
    ("poincare", 10, 1024, 2048, 1.0), ("lorentz", 11, 1024, 2048, 1.0),
    ("poincare", 10, 1024, 287, 1.0), ("lorentz", 11, 8, 287, 1.0),
    ("poincare", 10, 300, 2050, 0.5), ("lorentz", 11, 300, 2050, 0.5),
    # the general loop: D outside 10 and 11
    ("poincare", 1, 100, 301, 1.0), ("poincare", 1024, 37, 301, 0.5),
    ("lorentz", 3, 100, 287, 0.5), ("poincare", 10, 8, 5, 0.5),
    # more column tiles than one grid holds (65,535 × 128 columns): two
    # launches, the second at a column-tile offset
    pytest.param("poincare", 10, 2, 65535 * 128 + 5, 1.0,
                 id="poincare-10-past-grid-y"),
    pytest.param("lorentz", 16, 2, 65535 * 128 + 5, 0.5,
                 id="lorentz-16-past-grid-y")])
def test_pdist_kernel_matches_plain(dev, kind, d, n, m, c):
    rng = np.random.default_rng(0)
    x, y = rows(rng, n, d, kind, dev, c), rows(rng, m, d, kind, dev, c)
    before = pdist.launches
    got = pdist(x, y, c, manifold=kind)
    again = pdist(x, y, c, manifold=kind)
    torch.cuda.synchronize()
    assert pdist.launches == before + 2
    assert torch.equal(got, again)
    want = pdist_plain(x, y, c, manifold=kind)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c", [1.0, 0.5])
def test_pdist_kernel_duplicates_edge_and_offsets(dev, c):
    """Rows against their own copies give 0 exactly (the kernel sums the
    norms and the Gram in one order; the plain version's Gram leaves
    noise there, so those pairs are held to 0 alone); rows at ‖x‖ =
    (1 − 4e-3)/√c and unprojected rows (1 − c‖x‖² ≤ 0) within the tier;
    y an offset view (its rows off 16-byte boundaries)."""
    rng = np.random.default_rng(11)
    x = rows(rng, 64, 10, "poincare", dev, c)
    base = rows(rng, 2051, 10, "poincare", dev, c)
    x[::4] = x[::4] / torch.linalg.norm(x[::4], dim=1, keepdim=True) * (
        (1 - 4e-3) / np.sqrt(c))
    x[1::8] = x[1::8] / torch.linalg.norm(x[1::8], dim=1, keepdim=True) * (
        1.2 / np.sqrt(c))
    base[3:3 + 64 * 16:16] = x
    y = base[3:]
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    got = pdist(x, y, c, manifold="poincare")
    want = pdist_plain(x, y, c, manifold="poincare")
    dup = torch.zeros_like(got, dtype=torch.bool)
    dup[torch.arange(64), torch.arange(64) * 16] = True
    assert bool((got[dup] == 0).all())
    torch.testing.assert_close(got[~dup], want[~dup], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,d", [("poincare", 10), ("lorentz", 11),
                                    ("euclidean", 3), ("poincare", 1024)])
@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("b", [5, 300])
def test_scan_topk_kernel_matches_plain(dev, kind, d, k, b):
    rng = np.random.default_rng(1)
    m = 3000
    slab, q = rows(rng, m, d, kind, dev), rows(rng, b, d, kind, dev)
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    for ex, col0, n in ((False, 0, m), (True, 400, 400 + m - 77)):
        qi = torch.as_tensor(rng.integers(col0, col0 + m, b),
                             dtype=torch.int32, device=dev)
        gd, gi = scan_topk(slab, q, qi, col0, spec=spec, k=k, n=n,
                           exclude_self=ex)
        torch.cuda.synchronize()
        wd, wi = scan_topk_plain(slab, q, qi, col0, kind=kind, c=spec[1],
                                 k=k, n=n, exclude_self=ex)
        assert topk_disagreements(gi.cpu().numpy(), gd.cpu().numpy(),
                                  wi.cpu().numpy(), wd.cpu().numpy(),
                                  rtol=RTOL, atol=ATOL) == 0


def test_scan_topk_narrow_slab_and_ties(dev):
    rng = np.random.default_rng(2)
    base = rows(rng, 40, 10, "poincare", dev)
    slab = torch.cat([base, base, base])               # exact ties
    q = rows(rng, 6, 10, "poincare", dev)
    qi = torch.zeros(6, dtype=torch.int32, device=dev)
    gd, gi = scan_topk(slab, q, qi, 3, spec=("poincare", 1.0), k=200,
                       n=3 + 120)
    wd, wi = scan_topk_plain(slab, q, qi, 3, kind="poincare", c=1.0, k=200,
                             n=123, exclude_self=False)
    assert torch.equal(gi, wi)
    assert torch.all(torch.isinf(gd[:, 120:])) and torch.all(gi[:, 120:] == -1)
    assert torch.all(gi[:, 1:3] - gi[:, :2] == 40)     # ties in column order


@pytest.mark.parametrize("kind", ["poincare", "lorentz"])
def test_engine_scan_modes_agree_on_cuda(dev, kind):
    rng = np.random.default_rng(3)
    table = rows(rng, 5000, 11 if kind == "lorentz" else 10, kind,
                 dev).cpu().numpy()
    q = np.arange(0, 5000, 37)
    out = {}
    for mode in ("two_stage", "fused"):
        eng = QueryEngine(table, (kind, 1.0), scan_mode=mode,
                          chunk_rows=1024)
        i, d = eng.topk_neighbors(q, 10)
        out[mode] = (i.cpu().numpy(), d.cpu().numpy())
    cpu = QueryEngine(table, (kind, 1.0), device="cpu", chunk_rows=1024)
    ci, cd = (a.numpy() for a in cpu.topk_neighbors(q, 10))
    for i, d in out.values():
        assert topk_disagreements(i, d, ci, cd, rtol=RTOL, atol=ATOL) == 0


def assert_cand_close(kind, table, got, want):
    """Ids equal outside near-ties; distances within RTOL/ATOL, or for
    hyperboloid rows the arcosh arguments u = cosh(d) − 1 within twice
    the Gram form's forward-error bound (D + 2)·2^-24·Σ|x_i y_i|, taken
    at the table's largest Σ|x_i| (rows lifted from radius 0.9 have
    x_0 up to 9.5, where an ulp of the Gram is 1e-4 of a near d)."""
    (gd, gi), (wd, wi) = got, want
    if kind == "lorentz":
        x1 = float(table.abs().sum(dim=1).max())
        tol = dict(rtol=RTOL,
                   atol=2.0 * (table.shape[1] + 2) * 2.0 ** -24 * x1 * x1)
        gd, wd = (2.0 * torch.sinh(t.double() / 2.0) ** 2 for t in (gd, wd))
    else:
        tol = dict(rtol=RTOL, atol=ATOL)
    assert topk_disagreements(gi.cpu().numpy(), gd.cpu().numpy(),
                              wi.cpu().numpy(), wd.cpu().numpy(),
                              **tol) == 0


@pytest.mark.parametrize("kind,d", [("poincare", 10), ("lorentz", 11),
                                    ("euclidean", 3)])
@pytest.mark.parametrize("k", [10, 256])
def test_scan_topk_cand_kernel_matches_plain(dev, kind, d, k):
    """B = 1024, C = 4,600 (no multiple of 32) with pads in mid-list, a
    query with no candidate, exclude_self; twice, bitwise."""
    rng = np.random.default_rng(7)
    table = rows(rng, 20000, d, kind, dev)
    q = rows(rng, 1024, d, kind, dev)
    cand = torch.as_tensor(rng.integers(0, 20000, (1024, 4600)),
                           dtype=torch.int32, device=dev)
    cand[:, 1000:1033] = -1
    cand[9] = -1
    qi = cand[:, 17].clone()
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    before = scan_topk_cand.launches
    got = scan_topk_cand(table, cand, q, qi, spec=spec, k=k,
                         exclude_self=True)
    again = scan_topk_cand(table, cand, q, qi, spec=spec, k=k,
                           exclude_self=True)
    torch.cuda.synchronize()
    assert scan_topk_cand.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = scan_topk_cand_plain(table, cand, q, qi, kind=kind, c=spec[1],
                                k=k, exclude_self=True)
    assert_cand_close(kind, table, got, want)
    assert torch.all(got[1][9] == -1) and torch.all(torch.isinf(got[0][9]))
    assert not torch.any((got[1] == qi[:, None]) & (qi[:, None] >= 0))


def test_scan_topk_cand_kernel_narrow_lists(dev):
    """k above the reachable candidates: (+inf, -1) past them."""
    rng = np.random.default_rng(8)
    table = rows(rng, 500, 10, "poincare", dev)
    q = rows(rng, 40, 10, "poincare", dev)
    cand = torch.as_tensor(rng.integers(0, 500, (40, 37)),
                           dtype=torch.int32, device=dev)
    cand[:, 3:8] = -1
    qi = torch.full((40,), -1, dtype=torch.int32, device=dev)
    got = scan_topk_cand(table, cand, q, qi, spec=("poincare", 1.0), k=64)
    want = scan_topk_cand_plain(table, cand, q, qi, kind="poincare", c=1.0,
                                k=64, exclude_self=False)
    assert_cand_close("poincare", table, got, want)
    assert torch.all(torch.isinf(got[0][:, 32:])) and torch.all(
        got[1][:, 32:] == -1)


@pytest.mark.parametrize("kind,d,off", [
    ("poincare", 7, 0), ("lorentz", 4, 0), ("euclidean", 10, 0),
    ("poincare", 10, 1), ("lorentz", 11, 1), ("euclidean", 11, 1)])
@pytest.mark.parametrize("b", [8, 1024])
def test_scan_topk_cand_kernel_widths_and_views(dev, kind, d, off, b):
    """D = 10 and 11 (compile-time, 8-byte loads where the table allows)
    and other D (the general loop), tables that are views one float into
    their storage, C = 777 with pads and duplicate ids, k 64; a batch of
    8 splits the positions, one of 1,024 does not; twice, bitwise."""
    from hyperspace_torch.kernels import scan_topk as T

    rng = np.random.default_rng(d + 10 * off + b)
    base = rows(rng, 5000, d, kind, dev)
    table = torch.empty(5000 * d + off, device=dev)[off:].view(5000, d)
    table.copy_(base)
    if off:
        assert table.data_ptr() % 8
    q = rows(rng, b, d, kind, dev)
    cand = torch.as_tensor(rng.integers(0, 5000, (b, 777)),
                           dtype=torch.int32, device=dev)
    cand[:, 200:260] = -1
    cand[:, 400:450] = cand[:, :50]
    qi = cand[:, 3].clone()
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    assert (T._cand_splits(b, 777, 64, dev) > 1) == (b == 8)
    got = scan_topk_cand(table, cand, q, qi, spec=spec, k=64,
                         exclude_self=True)
    again = scan_topk_cand(table, cand, q, qi, spec=spec, k=64,
                           exclude_self=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = scan_topk_cand_plain(base, cand, q, qi, kind=kind, c=spec[1],
                                k=64, exclude_self=True)
    assert_cand_close(kind, base, got, want)
    assert not torch.any(got[1] == qi[:, None])


def test_scan_topk_cand_tie_goes_to_the_earlier_position(dev):
    """Ids 50 and 9,000 hold the same row; every query lists 9,000 at
    position 0 and 50 at the last (C 4,600), in different splits of a
    batch of 8: the earlier position, the higher id, comes first, where
    a (distance, id) key would put 50 first."""
    from hyperspace_torch.kernels import scan_topk as T

    rng = np.random.default_rng(11)
    table = rows(rng, 20000, 10, "poincare", dev)
    table[50] = table[9000]
    q = (table[9000] * 0.99)[None].expand(8, 10).contiguous()
    cand = torch.as_tensor(rng.integers(100, 9000, (8, 4600)),
                           dtype=torch.int32, device=dev)
    cand[:, 0], cand[:, -1] = 9000, 50
    qi = torch.full((8,), -1, dtype=torch.int32, device=dev)
    assert T._cand_splits(8, 4600, 10, dev) > 1
    got = scan_topk_cand(table, cand, q, qi, spec=("poincare", 1.0), k=10)
    want = scan_topk_cand_plain(table, cand, q, qi, kind="poincare", c=1.0,
                                k=10, exclude_self=False)
    assert_cand_close("poincare", table, got, want)
    for row in got[1].tolist():
        assert row.index(9000) < row.index(50)


@pytest.mark.parametrize("kind,d", [("poincare", 10), ("lorentz", 11),
                                    ("euclidean", 3)])
@pytest.mark.parametrize("m,k", [(3, 170), (8, 256)])
def test_scan_topk_pq_kernel_matches_plain(dev, kind, d, m, k):
    """Lookup tables from lifted queries and codebooks of lifted table
    rows; col0 and n cut; the kernel adds the terms in the plain
    version's order, so ids and distances agree to an ulp of log1p."""
    from hyperspace_torch.serve.index import _lift

    rng = np.random.default_rng(9)
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    table = rows(rng, 30000, d, kind, dev)
    lift = _lift(spec, table)
    ds = -(-lift.shape[1] // m)
    lift = torch.nn.functional.pad(lift, (0, m * ds - lift.shape[1]))
    pick = torch.as_tensor(rng.integers(0, 30000, (m, 256)), device=dev)
    cb = torch.stack([lift[pick[s], s * ds:(s + 1) * ds]
                      for s in range(m)])
    codes = torch.as_tensor(rng.integers(0, 256, (30000, m)),
                            dtype=torch.uint8, device=dev)
    q = rows(rng, 1024, d, kind, dev)
    lut = pq_lut(_lift(spec, q), cb, kind=kind)
    qi = torch.as_tensor(rng.integers(400, 30400, 1024), dtype=torch.int32,
                         device=dev)
    before = scan_topk_pq.launches
    got = scan_topk_pq(codes, lut, qi, 400, spec=spec, k=k, n=30300,
                       exclude_self=True)
    again = scan_topk_pq(codes, lut, qi, 400, spec=spec, k=k, n=30300,
                         exclude_self=True)
    torch.cuda.synchronize()
    assert scan_topk_pq.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    wd, wi = scan_topk_pq_plain(codes, lut, qi, 400, kind=kind, c=spec[1],
                                k=k, n=30300, exclude_self=True)
    assert torch.equal(got[1], wi)
    torch.testing.assert_close(got[0], wd, rtol=1e-6, atol=1e-6)


def assert_slab_close(kind, slab, q, got, want):
    """:func:`assert_cand_close`; for ball rows the arcosh arguments
    u = cosh(d) − 1 within twice the Gram form's forward-error bound
    2c·(D + 2)·2^-24·(|x| + |y|)² / ((1 − c|x|²)(1 − c|y|²)), taken at
    the case's largest radii (at D = 2 the rows are dense enough that
    f32 near-ties closer than ATOL fall where the two versions' roundings
    differ by more, growing as 1/den toward the boundary)."""
    if kind != "poincare":
        assert_cand_close(kind, slab, got, want)
        return
    (gd, gi), (wd, wi) = got, want
    rx = float(q.norm(dim=1).max())
    ry = float(slab.norm(dim=1).max())
    den = (1.0 - rx * rx) * (1.0 - ry * ry)
    atol = 2.0 * 2.0 * (slab.shape[1] + 2) * 2.0 ** -24 * (rx + ry) ** 2 / den
    gu, wu = (2.0 * torch.sinh(t.double() / 2.0) ** 2 for t in (gd, wd))
    assert topk_disagreements(gi.cpu().numpy(), gu.cpu().numpy(),
                              wi.cpu().numpy(), wu.cpu().numpy(),
                              rtol=RTOL, atol=atol) == 0


def storm_rows(m, d, kind, dev):
    """Rows along one direction whose distance to the origin falls with
    the row index: every row beats every earlier one (an insertion
    storm for a query at the origin)."""
    t = torch.linspace(0.9, 0.01, m, dtype=torch.float64)
    dd = d - 1 if kind == "lorentz" else d
    x = torch.zeros((m, dd), dtype=torch.float64)
    x[:, 0] = t if kind == "euclidean" else torch.tanh(t)
    x = x.to(torch.float32).to(dev)
    return ball_to_lorentz(x, 1.0).contiguous() if kind == "lorentz" else x


def origin(b, d, kind, dev):
    q = torch.zeros((b, d), dtype=torch.float32, device=dev)
    if kind == "lorentz":
        q[:, 0] = 1.0
    return q


def twice_equal(run):
    got, again = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    return got


SLAB_WIDTHS = [("poincare", 2), ("poincare", 10), ("poincare", 17),
               ("poincare", 130), ("lorentz", 11), ("lorentz", 40),
               ("euclidean", 10)]


@pytest.mark.parametrize("b", [1, 8, 1024])
@pytest.mark.parametrize("k", [1, 32, 33, 170, 256])
@pytest.mark.parametrize("kind,d", SLAB_WIDTHS)
def test_scan_topk_storms_ties_and_unaligned_views(dev, kind, d, k, b):
    """The redesigned slab scan: random rows read through a view at an
    odd float offset (col0 and n cut, exclude_self), an insertion storm,
    and a slab of identical rows, whose answer is exactly the lowest k
    reachable columns.  Each case launched twice, bitwise equal."""
    rng = np.random.default_rng(12 + d + k + b)
    m = 3001
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    base = rows(rng, m + 1, d, kind, dev)
    slab = base[1:]                           # 4·d bytes past the start
    q = rows(rng, b, d, kind, dev)
    col0, n = 13, 13 + m - 40
    qi = torch.as_tensor(rng.integers(col0, col0 + m, b), dtype=torch.int32,
                         device=dev)
    kw = dict(k=k, n=n, exclude_self=True)
    got = twice_equal(lambda: scan_topk(slab, q, qi, col0, spec=spec, **kw))
    want = scan_topk_plain(slab, q, qi, col0, kind=kind, c=spec[1], **kw)
    assert_slab_close(kind, slab, q, got, want)

    storm = storm_rows(m, d, kind, dev)
    q0 = origin(b, d, kind, dev)
    got = twice_equal(lambda: scan_topk(storm, q0, qi, col0, spec=spec,
                                        **kw))
    want = scan_topk_plain(storm, q0, qi, col0, kind=kind, c=spec[1], **kw)
    assert_slab_close(kind, storm, q0, got, want)

    # identical rows: one distance a query, so the lowest k columns.  The
    # plain version's GEMM need not give identical rows identical bits
    # (at D = 130 it does not), so it is held by tolerance here.
    tied = base[:1].expand(m, d).contiguous()
    got = twice_equal(lambda: scan_topk(tied, q, qi, col0, spec=spec, **kw))
    want = scan_topk_plain(tied, q, qi, col0, kind=kind, c=spec[1], **kw)
    assert_slab_close(kind, tied, q, got, want)
    assert torch.equal(got[0], got[0][:, :1].expand(b, k))
    cols = torch.arange(col0, n, device=dev)
    for r in range(b):
        lowest = cols[cols != qi[r]][:k]
        assert torch.equal(got[1][r, :lowest.numel()].long(), lowest)


def ordered_lut(b, m, kind, dev):
    """Lookup tables that make a row's ADC sum v·2^-12 (Euclidean) or
    −1 − v·2^-12 (the hyperbolic closed form) exactly, v = 256·code0 +
    code1: the codes lay out the distance order."""
    lut = torch.zeros((b, m * 256), dtype=torch.float32, device=dev)
    j = torch.arange(256, dtype=torch.float32, device=dev)
    sign = 1.0 if kind == "euclidean" else -1.0
    lut[:, :256] = sign * j * 256 * 2.0 ** -12
    if m > 1:
        lut[:, 256:512] = sign * j * 2.0 ** -12
    if kind != "euclidean":
        lut[:, :256] -= 1.0
    return lut


@pytest.mark.parametrize("b", [1, 8, 1024])
@pytest.mark.parametrize("k", [1, 32, 33, 170, 256])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("kind", ["poincare", "lorentz", "euclidean"])
def test_scan_topk_pq_storms_ties_and_unaligned_views(dev, kind, m, k, b):
    """The redesigned ADC scan: random codes read through a view at an
    odd byte offset (col0 and n cut, exclude_self), an insertion storm
    (codes in falling distance order), and identical codes, whose answer
    is exactly the lowest k reachable columns.  Twice each, bitwise."""
    rng = np.random.default_rng(40 + m + k + b)
    rows_ = 9001
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    base = torch.as_tensor(rng.integers(0, 256, (rows_ + 1, m)),
                           dtype=torch.uint8, device=dev)
    codes = base[1:]                          # m bytes past the start
    lo = 0.1 if kind == "euclidean" else -1.3    # u = -c·ssum - 1 >= 0
    lut = torch.as_tensor(lo + rng.random((b, m * 256)) * 0.2,
                          dtype=torch.float32, device=dev)
    col0, n = 7, 7 + rows_ - 33
    qi = torch.as_tensor(rng.integers(col0, col0 + rows_, b),
                         dtype=torch.int32, device=dev)
    kw = dict(k=k, n=n, exclude_self=True)
    plain = dict(kind=kind, c=spec[1], **kw)
    got = twice_equal(lambda: scan_topk_pq(codes, lut, qi, col0, spec=spec,
                                           **kw))
    wd, wi = scan_topk_pq_plain(codes, lut, qi, col0, **plain)
    assert torch.equal(got[1], wi)
    torch.testing.assert_close(got[0], wd, rtol=1e-6, atol=1e-6)

    v = torch.arange(rows_ - 1, -1, -1, device=dev) % (256 * 256)
    storm = torch.zeros((rows_, m), dtype=torch.uint8, device=dev)
    storm[:, 0] = (v // 256 if m > 1 else v % 256).to(torch.uint8)
    if m > 1:
        storm[:, 1] = (v % 256).to(torch.uint8)
    olut = ordered_lut(b, m, kind, dev)
    got = twice_equal(lambda: scan_topk_pq(storm, olut, qi, col0, spec=spec,
                                           **kw))
    wd, wi = scan_topk_pq_plain(storm, olut, qi, col0, **plain)
    assert torch.equal(got[1], wi)
    torch.testing.assert_close(got[0], wd, rtol=1e-6, atol=1e-6)

    tied = base[:1].expand(rows_, m).contiguous()
    got = twice_equal(lambda: scan_topk_pq(tied, lut, qi, col0, spec=spec,
                                           **kw))
    wd, wi = scan_topk_pq_plain(tied, lut, qi, col0, **plain)
    assert torch.equal(got[1], wi)
    cols = torch.arange(col0, n, device=dev)
    for r in range(b):
        lowest = cols[cols != qi[r]][:k]
        assert torch.equal(got[1][r, :lowest.numel()].long(), lowest)


def test_slab_scans_repeat_bitwise_at_the_path_shapes(dev):
    """20 launches of each slab scan at the serving path's shapes (its
    splits share a threshold through atomics) give the same bits, one
    launch counted per call."""
    rng = np.random.default_rng(13)
    m, rows_ = 83968, 82115
    slab = torch.zeros((m, 10), device=dev)
    slab[:rows_] = rows(rng, rows_, 10, "poincare", dev)
    q = rows(rng, 1024, 10, "poincare", dev)
    qi = torch.as_tensor(rng.choice(rows_, 1024, replace=False),
                         dtype=torch.int32, device=dev)
    codes = torch.as_tensor(rng.integers(0, 256, (m, 3)), dtype=torch.uint8,
                            device=dev)
    lut = torch.as_tensor(rng.standard_normal((1024, 768)) * 0.1 - 1.2,
                          dtype=torch.float32, device=dev)
    spec = ("poincare", 1.0)
    for fn, args, k in ((scan_topk, (slab, q, qi, 0), 10),
                        (scan_topk_pq, (codes, lut, qi, 0), 170)):
        before = fn.launches
        first = fn(*args, spec=spec, k=k, n=rows_, exclude_self=True)
        for _ in range(19):
            again = fn(*args, spec=spec, k=k, n=rows_, exclude_self=True)
            assert torch.equal(first[0], again[0])
            assert torch.equal(first[1], again[1])
        assert fn.launches == before + 20


def test_build_index_on_cuda_repeats(dev):
    """The build on the card: k = 1 ``scan_topk`` assignment and one-hot
    cell sums (no float atomics) give the same index twice."""
    from hyperspace_torch.serve.index import build_index

    rng = np.random.default_rng(11)
    table = rows(rng, 5000, 10, "poincare", dev).cpu().numpy()
    before = scan_topk.launches
    a = build_index(table, ("poincare", 1.0), 50, iters=4)
    b = build_index(table, ("poincare", 1.0), 50, iters=4)
    assert scan_topk.launches > before
    assert a.fingerprint == b.fingerprint
    assert sorted(a.cells[a.cells >= 0].tolist()) == list(range(5000))


@pytest.mark.parametrize("precision,nprobe", [("f32", 2), ("pq", 0),
                                              ("pq", 2)])
def test_engine_ivf_pq_modes_agree_on_cuda(dev, precision, nprobe):
    """The index built on the card; fused and two-stage rank-identical
    and equal to the CPU engine on the same index and payload."""
    from hyperspace_torch.serve.artifact import build_quant_payload
    from hyperspace_torch.serve.index import build_index

    rng = np.random.default_rng(10)
    table = rows(rng, 6000, 10, "poincare", dev).cpu().numpy()
    spec = ("poincare", 1.0)
    index = build_index(table, spec, 40)
    quant = build_quant_payload(table, spec, "pq")
    q = np.arange(0, 6000, 41)
    out = {}
    for mode in ("two_stage", "fused"):
        eng = QueryEngine(table, spec, scan_mode=mode, precision=precision,
                          index=index, nprobe=nprobe, quant=quant)
        i, d = eng.topk_neighbors(q, 10)
        out[mode] = (i.cpu().numpy(), d.cpu().numpy())
    cpu = QueryEngine(table, spec, device="cpu", precision=precision,
                      index=index, nprobe=nprobe, quant=quant)
    ci, cd = (a.numpy() for a in cpu.topk_neighbors(q, 10))
    for i, d in out.values():
        assert topk_disagreements(i, d, ci, cd, rtol=RTOL, atol=ATOL) == 0


def assert_scatter_close(got, want, order_bound):
    """f32: rtol = atol = 1e-5; bf16: within one ulp of the result; both
    plus ``order_bound``, the f32 bound of summing the same terms in
    another order (2·k·2^-24·Σ|term| for a row of k terms)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(w)
        tol = torch.where(w == 0, torch.zeros_like(w),
                          torch.ldexp(torch.ones_like(w), e - 8))
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    assert torch.all((g - w).abs() <= tol + order_bound)


def order_bound(recv, abs_sum, n):
    k = torch.bincount(recv.long(), minlength=n).float()[:, None]
    return 2.0 * k * 2.0 ** -24 * abs_sum


def hazard_edges(rng, n, e, kind):
    """Receiver-sorted edges of a streaming-kernel hazard (real edges
    only): ``hub`` puts one row over many chunks, ``chunk_ends`` ends
    every row of 32 edges at a chunk end (a chunk holds a multiple of 32
    edges at F = 32 and 128), ``sparse`` leaves long runs of empty rows
    between single edges."""
    if kind == "hub":
        r = np.where(rng.random(e) < 0.7, n // 2, rng.integers(0, n, e))
    elif kind == "chunk_ends":
        r = np.repeat(np.arange(e // 32 + 1), 32)[:e] * 2
    else:
        r = rng.choice(n, e, replace=False)
    return np.sort(r).astype(np.int32)


def offset_view(x):
    """``x`` as a view one element into a copy of its storage: the same
    values from an unaligned data_ptr."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,kind", [
    pytest.param(300, 2000, 17, "random", id="300-2000-17"),
    pytest.param(50, 64, 128, "random", id="50-64-128"),
    pytest.param(7, 3, 5, "random", id="7-3-5"),
    pytest.param(1000, 5000, 130, "random", id="1000-5000-130"),
    pytest.param(500, 4000, 1, "random", id="500-4000-1"),
    pytest.param(64, 0, 8, "random", id="64-0-8"),
    pytest.param(2000, 20000, 300, "random", id="2000-20000-300"),
    pytest.param(2000, 20000, 33, "random", id="pitch-F33"),
    pytest.param(2000, 20000, 129, "random", id="pitch-F129"),
    pytest.param(3000, 50000, 128, "offset", id="unaligned-views-F128"),
    pytest.param(2000, 20000, 33, "offset", id="unaligned-views-F33"),
    pytest.param(300, 30000, 128, "hub", id="hub-over-chunks-F128"),
    pytest.param(9000, 6144, 128, "chunk_ends", id="rows-end-at-chunk-ends"),
    pytest.param(9000, 6144, 32, "chunk_ends",
                 id="rows-end-at-chunk-ends-F32"),
    pytest.param(169343, 3000, 128, "sparse", id="long-empty-runs"),
    pytest.param(169343, 3000, 33, "sparse", id="long-empty-runs-F33"),
    pytest.param(64, 0, 128, "random", id="no-edges-F128")])
def test_csr_segment_sum_kernel_matches_plain(dev, dt, n, e, f, kind):
    rng = np.random.default_rng(n + e + f)
    if kind in ("random", "offset"):
        # a hub row, empty rows and a zero-valued padding tail at row n - 1
        r = np.sort(np.where(rng.random(e) < 0.3, n // 3,
                             rng.integers(0, max(n // 2, 1), e)))
        r = np.concatenate([r, np.full(37, n - 1)]).astype(np.int32)
    else:
        r = hazard_edges(rng, n, e, kind)
    v = torch.as_tensor(rng.standard_normal((len(r), f)), dtype=dt,
                        device=dev)
    v[e:] = 0
    rr = torch.as_tensor(r, device=dev)
    if kind == "offset":
        v, rr = offset_view(v), offset_view(rr)
        assert v.data_ptr() % 16 and rr.data_ptr() % 16
    before = csr_segment_sum.launches
    got = csr_segment_sum(v, rr, None, n)
    again = csr_segment_sum(v, rr, None, n)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 2
    assert torch.equal(got, again)
    want = csr_segment_sum_plain(v, rr, n)
    assert_scatter_close(got, want, order_bound(
        rr, csr_segment_sum_plain(v.float().abs(), rr, n), n))
    k = torch.bincount(rr.long(), minlength=n)
    assert torch.all(got[k == 0] == 0)
    if kind in ("random", "offset"):
        assert torch.all(got[n // 2 + 1:n - 1] == 0) or n < 4


def _by_pair(r, s, n):
    key = (r // 256).astype(np.int64) * (n // 256 + 1) + s // 256
    o = np.argsort(key, kind="stable")
    return r[o], s[o]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,lo,hi", [(700, 4000, 32, 0, 700),
                                         (1000, 20000, 128, 300, 301),
                                         (300, 900, 130, 0, 300),
                                         (257, 513, 8, 0, 257),
                                         (1500, 600, 16, 512, 768),
                                         (3000, 30000, 33, 0, 3000),
                                         (600, 5000, 300, 0, 600)])
def test_cluster_aggregate_kernel_matches_plain(dev, dt, n, e, f, lo, hi):
    rng = np.random.default_rng(n + e + f)
    # receiver-sorted, then (receiver block, sender block), as the split
    # leaves them; (300, 301) is one hub row of 20,000 edges
    r, s = _by_pair(np.sort(rng.integers(lo, hi, e)).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32), n)
    h = torch.as_tensor(rng.standard_normal((n, f)), dtype=dt, device=dev)
    w = torch.as_tensor(rng.random(e), dtype=torch.float32, device=dev)
    rr, ss = torch.as_tensor(r, device=dev), torch.as_tensor(s, device=dev)
    before = cluster_aggregate.launches
    got = cluster_aggregate(h, w, rr, ss, None, n)
    torch.cuda.synchronize()
    assert cluster_aggregate.launches == before + 1
    want = cluster_aggregate_plain(h, w, rr, ss, n)
    assert_scatter_close(got, want, order_bound(rr, cluster_aggregate_plain(
        h.float().abs(), w.to(dt).float(), rr, ss, n), n))
    if lo:
        assert torch.all(got[:lo] == 0) and torch.all(got[hi:] == 0)


def test_scatter_kernels_refuse_float64(dev):
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16, float32"):
        csr_segment_sum(torch.zeros((4, 3), dtype=torch.float64,
                                    device=dev), ids, None, 4)
    with pytest.raises(ValueError, match="int32"):
        csr_segment_sum(torch.zeros((4, 3), device=dev), ids.long(), None, 4)
    with pytest.raises(ValueError, match="bfloat16, float32"):
        cluster_aggregate(torch.zeros((4, 3), dtype=torch.float64,
                                      device=dev),
                          torch.zeros(4, device=dev), ids, ids, None, 4)


# --- the HGCN attention arm --------------------------------------------------


def assert_att_close(got, want, scale, terms, weight_ulp=2.0 ** -23):
    """|got − want| ≤ (2·terms·2^-24 + weight_ulp)·scale: ``scale`` is the
    output's absolute term sum, ``terms`` the terms a sum holds (per
    row, broadcastable)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = (2.0 * terms * 2.0 ** -24 + weight_ulp) * scale.abs() + 1e-30
    assert torch.all((got - want).abs() <= tol)


def sorted_edges(rng, n, e):
    """Receiver-sorted edges with a hub row, empty rows and a padding
    tail at row n − 1."""
    r = np.sort(np.where(rng.random(e) < 0.3, n // 3,
                         rng.integers(0, max(n // 2, 1), e)))
    return np.concatenate([r, np.full(37, n - 1)]).astype(np.int32)


def reduce_1d_case(rng, n, e, kind, dev):
    """(values, receivers) of a B3 case; ``e`` counts the real edges
    and a padding tail of 0s (``random``, ``offset``) or all edges (the
    others).  The kernel takes tiles of 1024 edges:
    ``hub`` puts one row across many tiles, ``boundary`` ends rows
    exactly at tile ends, ``crossing`` runs rows over them, ``offset``
    hands both arrays over as views 4 bytes off 16-byte alignment,
    ``gaps`` leaves most rows between two edges empty (more long runs of
    empty rows in a tile than the block queues), ``short`` leaves a long
    empty range mid-way and stops far short of ``n - 1``, and ``none``
    has no edge at all."""
    if kind in ("random", "offset"):
        r = sorted_edges(rng, n, e)         # e real edges, 37 padding
    elif kind == "hub":
        r = np.sort(np.concatenate([np.full(9000, n // 2),
                                    rng.integers(0, n, e)]))
    elif kind == "boundary":
        r = np.repeat(np.arange(4), [1024, 1024, 512, 512])
    elif kind == "crossing":
        r = np.repeat(np.arange(5), [1000, 100, 2000, 5, 3])
    elif kind == "gaps":
        r = np.sort(rng.choice(n, e, replace=False))
    elif kind == "short":
        r = np.sort(np.concatenate([rng.integers(0, 500, e // 2),
                                    rng.integers(n // 2, n // 2 + 500,
                                                 e - e // 2)]))
    else:
        r = np.zeros(0)
    r = r.astype(np.int32)
    v = rng.standard_normal(len(r))
    if kind in ("random", "offset"):
        v[e:] = 0
    if kind == "offset":
        rb = torch.zeros(len(r) + 1, dtype=torch.int32, device=dev)
        vb = torch.zeros(len(r) + 1, dtype=torch.float32, device=dev)
        rb[1:] = torch.as_tensor(r, device=dev)
        vb[1:] = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return vb[1:], rb[1:]
    return (torch.as_tensor(v, dtype=torch.float32, device=dev),
            torch.as_tensor(r, device=dev))


@pytest.mark.parametrize("n,e,kind", [
    pytest.param(300, 2000, "random", id="300-2000"),
    pytest.param(7, 3, "random", id="7-3"),
    pytest.param(2000, 200000, "random", id="2000-200000"),
    pytest.param(64, 0, "random", id="64-0"),
    pytest.param(500, 3000, "hub", id="hub-over-tiles"),
    pytest.param(6, 3072, "boundary", id="rows-end-at-tile-ends"),
    pytest.param(7, 3108, "crossing", id="rows-cross-tile-ends"),
    pytest.param(3000, 50000, "offset", id="unaligned-views"),
    pytest.param(900, 300, "random", id="under-one-tile"),
    pytest.param(169343, 2000, "gaps", id="many-long-gaps"),
    pytest.param(169343, 5000, "short", id="receivers-stop-short"),
    pytest.param(50, 0, "none", id="no-edges")])
def test_csr_segment_reduce_1d_kernel_matches_plain(dev, n, e, kind):
    rng = np.random.default_rng(n + e)
    v, rr = reduce_1d_case(rng, n, e, kind, dev)
    if kind == "offset":
        assert v.data_ptr() % 16 and rr.data_ptr() % 16
    k = torch.bincount(rr.long(), minlength=n).float()
    for op in ("sum", "max"):
        before = csr_segment_reduce_1d.launches
        got = csr_segment_reduce_1d(v, rr, None, n, op=op)
        again = csr_segment_reduce_1d(v, rr, None, n, op=op)
        torch.cuda.synchronize()
        assert csr_segment_reduce_1d.launches == before + 2
        assert torch.equal(got, again)
        want = csr_segment_reduce_1d_plain(v, rr, n, op=op)
        if op == "max":
            assert torch.equal(got, want)
            assert torch.all(got[k == 0] == -3.0e38)
        else:
            scale = csr_segment_reduce_1d_plain(v.abs(), rr, n)
            assert_att_close(got, want, scale, k, 0.0)
            assert torch.all(got[k == 0] == 0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,kind", [
    pytest.param(300, 2000, 128, "random", id="300-2000-128"),
    pytest.param(50, 64, 32, "random", id="50-64-32"),
    pytest.param(1000, 5000, 130, "random", id="1000-5000-130"),
    pytest.param(7, 3, 8, "random", id="7-3-8"),
    pytest.param(2000, 20000, 33, "random", id="2000-20000-33"),
    pytest.param(2000, 20000, 129, "random", id="pitch-F129"),
    pytest.param(3000, 50000, 128, "offset", id="unaligned-views-F128"),
    pytest.param(2000, 20000, 33, "offset", id="unaligned-views-F33"),
    pytest.param(300, 30000, 128, "hub", id="hub-over-chunks-F128"),
    pytest.param(9000, 6144, 128, "chunk_ends", id="rows-end-at-chunk-ends"),
    pytest.param(169343, 3000, 128, "sparse", id="long-empty-runs"),
    pytest.param(64, 0, 32, "random", id="no-edges")])
def test_csr_att_bwd_edges_kernel_matches_plain(dev, dt, n, e, f, kind):
    rng = np.random.default_rng(n + e + f)
    rr = torch.as_tensor(sorted_edges(rng, n, e) if kind in (
        "random", "offset") else hazard_edges(rng, n, e, kind), device=dev)
    m = len(rr)
    f32 = dict(dtype=torch.float32, device=dev)
    dn = torch.as_tensor(rng.standard_normal((n, f + 1)), **f32)
    h = torch.as_tensor(rng.standard_normal((m, f)), dtype=dt, device=dev)
    w = torch.as_tensor(rng.random(m) * 3, **f32)
    w[e:] = 0
    # bounded logits lie in (-30, 30)
    lm = torch.as_tensor(rng.standard_normal(m) * 8, **f32).clamp(-29, 29)
    lm[::50] = 0
    if kind == "offset":
        dn, h, w, lm, rr = (offset_view(x) for x in (dn, h, w, lm, rr))
        assert all(x.data_ptr() % 16 for x in (dn, h, w, lm, rr))
    before = csr_att_bwd_edges.launches
    got = csr_att_bwd_edges(dn, h, w, lm, rr, None, n, 30.0, 0.2)
    again = csr_att_bwd_edges(dn, h, w, lm, rr, None, n, 30.0, 0.2)
    torch.cuda.synchronize()
    assert csr_att_bwd_edges.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = csr_att_bwd_edges_plain(dn, h, w, lm, rr, n, 30.0, 0.2)
    sc = csr_att_bwd_edges_plain(dn.abs(), h.abs(), w, lm, rr, n, 30.0, 0.2)
    k = torch.bincount(rr.long(), minlength=n).float()
    assert_att_close(got[0], want[0], sc[0], f + 1)
    assert_att_close(got[1], want[1], sc[1], f + 1 + k)
    assert torch.all(got[0][e:] == 0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_segment_kernels_at_their_widest_rows(dev, dt):
    """Rows of MAX_CARD_F columns fit the kernels' shared memory (a chunk
    of one edge); one column more raises."""
    from hyperspace_torch.kernels.segment import MAX_CARD_F

    rng = np.random.default_rng(7)
    n, e, f = 12, 40, MAX_CARD_F
    rr = torch.as_tensor(np.sort(rng.integers(0, n, e)).astype(np.int32),
                         device=dev)
    v = torch.as_tensor(rng.standard_normal((e, f)), dtype=dt, device=dev)
    got = csr_segment_sum(v, rr, None, n)
    assert_scatter_close(got, csr_segment_sum_plain(v, rr, n), order_bound(
        rr, csr_segment_sum_plain(v.float().abs(), rr, n), n))
    f32 = dict(dtype=torch.float32, device=dev)
    dn = torch.as_tensor(rng.standard_normal((n, f + 1)), **f32)
    w = torch.as_tensor(rng.random(e) * 3, **f32)
    lm = torch.as_tensor(rng.standard_normal(e) * 8, **f32).clamp(-29, 29)
    got = csr_att_bwd_edges(dn, v, w, lm, rr, None, n, 30.0, 0.2)
    torch.cuda.synchronize()
    want = csr_att_bwd_edges_plain(dn, v, w, lm, rr, n, 30.0, 0.2)
    sc = csr_att_bwd_edges_plain(dn.abs(), v.abs(), w, lm, rr, n, 30.0, 0.2)
    k = torch.bincount(rr.long(), minlength=n).float()
    assert_att_close(got[0], want[0], sc[0], f + 1)
    assert_att_close(got[1], want[1], sc[1], f + 1 + k)
    with pytest.raises(ValueError, match="at most"):
        csr_segment_sum(torch.zeros(e, f + 1, dtype=dt, device=dev), rr,
                        None, n)


def pair_edges(rng, n, e_half, lo=0, hi=None):
    """A reversal-closed edge set sorted by (receiver block, sender
    block), as the cluster split leaves it."""
    hi = n if hi is None else hi
    u = rng.integers(lo, hi, e_half)
    v = rng.integers(0, n, e_half)
    r, s = np.concatenate([u, v]), np.concatenate([v, u])
    key = (r // 256) * (n // 256 + 1) + s // 256
    o = np.lexsort((s, r, key))
    return r[o].astype(np.int32), s[o].astype(np.int32)


# n, edges, f, rows of the first endpoint: (1000, 40000, …, 300, 301) puts
# 20,000 edges on one row (more than a block stages at once); (1500, 600,
# …) leaves most rows without an edge
ATT_CASES = [(700, 4000, 32, 0, 700), (300, 900, 130, 0, 300),
             (257, 513, 8, 0, 257), (3000, 30000, 128, 0, 3000),
             (1000, 40000, 33, 300, 301), (1500, 600, 16, 512, 768)]


def att_case(rng, dev, dt, n, e, f, lo, hi):
    r, s = pair_edges(rng, n, e // 2, lo, hi)
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.as_tensor(rng.standard_normal((n, f)), dtype=dt, device=dev)
    a_s = torch.as_tensor(rng.standard_normal(n) * 0.7, **f32)
    a_r = torch.as_tensor(rng.standard_normal(n) * 0.7 + 0.3, **f32)
    g = torch.as_tensor(rng.standard_normal((n, f + 1)), **f32)
    return (h, a_s, a_r, torch.as_tensor(r, device=dev),
            torch.as_tensor(s, device=dev), g)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATT_CASES)
def test_cluster_att_kernels_match_plain(dev, dt, case):
    n, e, f, lo, hi = case
    rng = np.random.default_rng(n + e + f)
    h, a_s, a_r, r, s, g = att_case(rng, dev, dt, n, e, f, lo, hi)
    k = torch.bincount(r.long(), minlength=n).float()
    wulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -23
    before = (cluster_att_fwd.launches, cluster_att_bwd.launches)
    nd = cluster_att_fwd(h, a_s, a_r, r, s, None, n)
    nd2 = cluster_att_fwd(h, a_s, a_r, r, s, None, n)
    bw = cluster_att_bwd(g, h, a_s, a_r, r, s, None, n)
    bw2 = cluster_att_bwd(g, h, a_s, a_r, r, s, None, n)
    torch.cuda.synchronize()
    assert (cluster_att_fwd.launches, cluster_att_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(nd, nd2)
    assert all(torch.equal(a, b) for a, b in zip(bw, bw2))
    want = cluster_att_fwd_plain(h, a_s, a_r, r, s, n)
    assert_att_close(nd, want, cluster_att_fwd_plain(h.abs(), a_s, a_r, r, s,
                                                     n), k[:, None], wulp)
    want_b = cluster_att_bwd_plain(g, h, a_s, a_r, r, s, n)
    sc = cluster_att_bwd_plain(g.abs(), h.abs(), a_s, a_r, r, s, n)
    assert_att_close(bw[0], want_b[0], sc[0], k[:, None], wulp)
    for a, b, c in zip(bw[1:], want_b[1:], sc[1:]):
        assert_att_close(a, b, c, f + 1 + k)
    empty = k == 0                      # rows no edge reaches give 0
    for t in (nd, *bw):
        assert torch.all(t[empty] == 0)
    assert bool(empty.any()) or n < e   # fewer edges than rows: some empty


# --- the row plan: every width, hub rows, full blocks, unaligned views ------

ROW_WIDTHS = [1, 3, 31, 32, 33, 64, 127, 128, 129, 200]


def row_plan_case(kind):
    """(receivers, senders, n) of a reversal-closed edge set sorted by
    pair: ``random``; ``hub``, one row of 5,000 edges; ``full_block``, a
    receiver block of 6,000 edges (more than the forward stages at once);
    ``none``, no edge at all."""
    rng = np.random.default_rng(len(kind))
    if kind == "none":
        z = np.zeros(0, np.int32)
        return z, z, 500
    n, e_half, lo, hi = {"random": (700, 2000, 0, 700),
                         "hub": (900, 5000, 300, 301),
                         "full_block": (1000, 3000, 256, 512)}[kind]
    return (*pair_edges(rng, n, e_half, lo, hi), n)


def row_plan_cases():
    out = [pytest.param("random", f, off, id=f"random-F{f}-off{off}")
           for f in ROW_WIDTHS for off in (0, 1)]
    out += [pytest.param(kind, f, 0, id=f"{kind}-F{f}")
            for kind in ("hub", "full_block", "none") for f in (32, 128, 129)]
    return out


def row_inputs(dev, dt, n, f, e, off, seed):
    """h [n, f] of dt and the cotangent [n, f + 1] f32, both views
    ``off`` elements into their storage (off 1: unaligned data_ptrs)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n * f + off, generator=gen, device=dev).to(dt)[off:]
    g = torch.randn(n * (f + 1) + off, generator=gen, device=dev)[off:]
    w = torch.rand(e, generator=gen, device=dev)
    a_s = torch.randn(n, generator=gen, device=dev) * 0.7
    a_r = torch.randn(n, generator=gen, device=dev) * 0.7 + 0.3
    return h.view(n, f), g.view(n, f + 1), w, a_s, a_r


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,f,off", row_plan_cases())
def test_cluster_rows_kernels_match_plain(dev, dt, kind, f, off):
    """``cluster_aggregate`` and ``cluster_att_bwd`` on the row plan:
    against their plain versions, two launches bitwise equal, and a call
    without the plan (built on the card, counted) equal to one with it."""
    from hyperspace_torch.kernels import cluster as KC

    r, s, n = row_plan_case(kind)
    e = len(r)
    rows = KC.rows_on(KC.build_cluster_rows(r, s, n, with_rev=True), dev)
    rr, ss = torch.as_tensor(r, device=dev), torch.as_tensor(s, device=dev)
    h, g, w, a_s, a_r = row_inputs(dev, dt, n, f, e, off, n + f + off)
    if off:
        assert h.data_ptr() % 8 and g.data_ptr() % 8
    k = torch.bincount(rr.long(), minlength=n).float()
    launched = (cluster_aggregate.launches, cluster_att_bwd.launches,
                KC.row_plan_builds)
    got = cluster_aggregate(h, w, rr, ss, None, n, rows=rows)
    again = cluster_aggregate(h, w, rr, ss, None, n, rows=rows)
    built = cluster_aggregate(h, w, rr, ss, None, n)
    bw = cluster_att_bwd(g, h, a_s, a_r, rr, ss, None, n, rows=rows)
    bw2 = cluster_att_bwd(g, h, a_s, a_r, rr, ss, None, n, rows=rows)
    bw_built = cluster_att_bwd(g, h, a_s, a_r, rr, ss, None, n)
    torch.cuda.synchronize()
    live = int(e > 0)
    assert (cluster_aggregate.launches, cluster_att_bwd.launches,
            KC.row_plan_builds) == (launched[0] + 3 * live,
                                    launched[1] + 3 * live,
                                    launched[2] + 2 * live)
    assert torch.equal(got, again) and torch.equal(got, built)
    assert all(torch.equal(a, b) for a, b in zip(bw, bw2))
    assert all(torch.equal(a, b) for a, b in zip(bw, bw_built))
    want = cluster_aggregate_plain(h, w, rr, ss, n)
    assert_scatter_close(got, want, order_bound(rr, cluster_aggregate_plain(
        h.float().abs(), w.to(dt).float(), rr, ss, n), n))
    wulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -23
    want_b = cluster_att_bwd_plain(g, h, a_s, a_r, rr, ss, n)
    sc = cluster_att_bwd_plain(g.abs(), h.abs(), a_s, a_r, rr, ss, n)
    assert_att_close(bw[0], want_b[0], sc[0], k[:, None], wulp)
    for a, b, c in zip(bw[1:], want_b[1:], sc[1:]):
        assert_att_close(a, b, c, f + 1 + k)
    empty = k == 0
    for t in (got, *bw):
        assert torch.all(t[empty] == 0)


def fwd_plan_case(kind):
    """(receivers, senders, n): ``random`` (reversal-closed, by pair) or
    ``inner``, every edge among rows [300, 700) of 1,000, so that rows at
    both ends have none."""
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        return (*pair_edges(rng, 700, 2000), 700)
    r = rng.integers(300, 700, 5000)
    s = rng.integers(300, 700, 5000)
    o = np.argsort(r // 256 * 5 + s // 256, kind="stable")
    return r[o].astype(np.int32), s[o].astype(np.int32), 1000


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "inner"])
@pytest.mark.parametrize("f", [128, 33, 32, 5])
@pytest.mark.parametrize("off", [0, 1])
def test_cluster_att_fwd_on_the_row_plan(dev, dt, kind, f, off):
    """``cluster_att_fwd`` on the row plan against its plain version, h
    aligned and a view one element into its storage; two launches
    bitwise equal, and a call without the plan (built on the card,
    counted) equal to one with it; rows no edge reaches give 0 in all
    f + 1 columns."""
    from hyperspace_torch.kernels import cluster as KC

    r, s, n = fwd_plan_case(kind)
    rows = KC.rows_on(KC.build_cluster_rows(r, s, n), dev)
    rr, ss = torch.as_tensor(r, device=dev), torch.as_tensor(s, device=dev)
    h, _, _, a_s, a_r = row_inputs(dev, dt, n, f, len(r), off, n + f + off)
    k = torch.bincount(rr.long(), minlength=n).float()
    before = (cluster_att_fwd.launches, KC.row_plan_builds)
    got = cluster_att_fwd(h, a_s, a_r, rr, ss, None, n, rows=rows)
    again = cluster_att_fwd(h, a_s, a_r, rr, ss, None, n, rows=rows)
    built = cluster_att_fwd(h, a_s, a_r, rr, ss, None, n)
    torch.cuda.synchronize()
    assert (cluster_att_fwd.launches, KC.row_plan_builds) == (
        before[0] + 3, before[1] + 1)
    assert torch.equal(got, again) and torch.equal(got, built)
    wulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -23
    want = cluster_att_fwd_plain(h, a_s, a_r, rr, ss, n)
    assert_att_close(got, want, cluster_att_fwd_plain(h.abs(), a_s, a_r, rr,
                                                      ss, n), k[:, None], wulp)
    assert got.shape == (n, f + 1) and torch.all(got[k == 0] == 0)
    if kind == "inner":
        assert bool((k[:300] == 0).all()) and bool((k[700:] == 0).all())


def test_attention_kernels_refuse_what_they_do_not_take(dev):
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    v = torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="float32"):
        csr_segment_reduce_1d(v.double(), ids, None, 4)
    with pytest.raises(ValueError, match="int32"):
        csr_segment_reduce_1d(v, ids.long(), None, 4)
    h = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError, match="bfloat16, float32"):
        csr_att_bwd_edges(torch.zeros((4, 4), device=dev), h.double(), v, v,
                          ids, None, 4, 30.0, 0.2)
    with pytest.raises(ValueError, match="float32"):
        csr_att_bwd_edges(torch.zeros((4, 4), device=dev), h, v.half(), v,
                          ids, None, 4, 30.0, 0.2)
    with pytest.raises(ValueError, match="bfloat16, float32"):
        cluster_att_fwd(h.double(), v, v, ids, ids, None, 4)
    with pytest.raises(ValueError, match="int32"):
        cluster_att_bwd(torch.zeros((4, 4), device=dev), h, v, v, ids.long(),
                        ids, None, 4)


def test_att_train_step_on_the_card_matches_the_cpu(dev):
    """Two attention LP steps at 3,000 nodes with a forced cluster split
    and the gate open, card against CPU from the same parameters and
    negatives: f32 lanes within rtol 1e-4 of the loss."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels.cluster import build_cluster_split

    split, _ = B.arxiv_scale_split(3000, cluster_min_pair=128)
    g = split.graph
    g.cluster_split = build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, 3000,
        min_pair_edges=128, rev_perm=g.rev_perm)
    assert 0.5 < g.cluster_split.frac_clustered < 1.0
    runs = {}
    for where in ("cpu", "cuda"):
        s = B.setup_lp(device=where, split=split, agg_dtype=None,
                       decoder_dtype=None, use_att=True)
        s.ga.cluster.use_att_cluster = True
        gen = torch.Generator().manual_seed(5)
        losses = []
        for _ in range(2):
            neg_v = torch.randint(0, 3000, s.neg_u.shape, generator=gen,
                                  dtype=torch.int32)
            losses.append(float(s.step(neg_v.to(s.device))))
        runs[where] = losses
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """Two LP steps at 3,000 nodes with a forced cluster split, card
    against CPU from the same parameters and negatives: f32 lanes within
    rtol 1e-4 of the loss."""
    from hyperspace_torch.benchmarks import hgcn_bench as B
    from hyperspace_torch.kernels.cluster import build_cluster_split

    split, _ = B.arxiv_scale_split(3000)
    g = split.graph
    g.cluster_split = build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, 3000, min_pair_edges=8,
        rev_perm=g.rev_perm)
    runs = {}
    for where in ("cpu", "cuda"):
        # the same seed gives the same initial parameters on both
        s = B.setup_lp(device=where, split=split, agg_dtype=None,
                       decoder_dtype=None)
        gen = torch.Generator().manual_seed(5)
        losses = []
        for _ in range(2):
            neg_v = torch.randint(0, 3000, s.neg_u.shape, generator=gen,
                                  dtype=torch.int32)
            losses.append(float(s.step(neg_v.to(s.device))))
        runs[where] = losses
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)


# --- HyboNet: flash attention and hyp_mlr ------------------------------------
# Tolerances: f32 kernels against their f32 plain versions, which sum the
# same terms in other orders: values rtol 1e-4 / atol 1e-5; backward
# results within 1e-4 of the largest entry; the whole Function against
# autograd of the dense twin within 2e-3 of the largest entry (the
# clamps differ at the epilogue, as in the JAX package's own test).


def hyperboloid_rows(rng, shape, dev, scale=0.7):
    sp = rng.standard_normal(shape[:-1] + (shape[-1] - 1,)) * scale
    t = np.sqrt(1.0 + np.sum(sp * sp, axis=-1, keepdims=True))
    return torch.as_tensor(np.concatenate([t, sp], axis=-1),
                           dtype=torch.float32, device=dev)


def attention_case(rng, dev, b, group, nq, nk, d, masked, empty=()):
    q = hyperboloid_rows(rng, (b, nq, d), dev)
    k = hyperboloid_rows(rng, (b, nk, d), dev)
    v = hyperboloid_rows(rng, (b, nk, d), dev)
    beta = torch.as_tensor(rng.standard_normal(b) * 0.3, dtype=torch.float32,
                           device=dev)
    tau = torch.as_tensor(1.0 + rng.random(b), dtype=torch.float32,
                          device=dev)
    mask = None
    if masked:
        m = rng.random((b // group, nq, nk)) > 0.3
        m[:, list(empty), :] = False
        mask = torch.as_tensor(m.astype(np.uint8), device=dev)
    return q, k, v, beta, tau, mask


def scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-3)


# b, group, nq, nk, d, masked, empty query rows ("all": every row of the
# first sequence); D from 1 to 72, ragged Nq (not a multiple of 16) and
# Nk (not a multiple of 8), a mask over an odd Nk; the last two launch too
# few blocks to fill the card, so the backward kernels cut the other side
# into parts (ragged ones in the last)
FLASH_SHAPES = [(8, 4, 128, 128, 33, True, (100, 127)),
                (6, 2, 70, 130, 9, True, (0, 69)),
                (3, 1, 1, 200, 33, False, ()),
                (2, 1, 65, 33, 72, True, (64,)),
                (4, 4, 31, 257, 16, True, ()),
                (2, 1, 40, 50, 1, True, ()),
                (2, 2, 64, 64, 8, False, ()),
                (4, 2, 96, 150, 40, True, (5,)),
                (2, 1, 17, 70, 33, True, ()),
                (3, 1, 40, 9, 33, True, ()),
                (4, 2, 50, 33, 33, True, (3,)),
                (4, 2, 48, 100, 33, True, "all"),
                (2, 2, 2048, 2048, 33, True, (5,)),
                (2, 1, 700, 2100, 33, True, (3, 699))]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernels_match_plain(dev, shape):
    from hyperspace_torch.kernels import attention as A

    b, group, nq, nk, d, masked, empty = shape
    rng = np.random.default_rng(nq + nk + d)
    rows_out = () if empty == "all" else empty
    q, k, v, beta, tau, mask = attention_case(rng, dev, b, group, nq, nk, d,
                                              masked, rows_out)
    if empty == "all":
        mask[0] = 0                 # every head of the first sequence
    before = (A.flash_fwd.launches, A.flash_dq.launches,
              A.flash_dkv.launches)
    out, lse, nrm = A.flash_fwd(q, k, v, 1.0, beta, tau, mask, group)
    out2, lse2, _ = A.flash_fwd(q, k, v, 1.0, beta, tau, mask, group)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    w_out, w_lse, w_nrm = A.flash_fwd_plain(q, k, v, 1.0, beta, tau, mask,
                                            group)
    torch.testing.assert_close(out, w_out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, w_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nrm, w_nrm, rtol=1e-4, atol=1e-6)
    for r in rows_out:
        assert torch.all(out[:, r] == 0) and torch.all(lse[:, r] == 1e30)
    if empty == "all":
        assert torch.all(out[:group] == 0) and torch.all(lse[:group] == 1e30)
    dsp = torch.randn(out.shape, device=dev)
    di = torch.sum(dsp * out, dim=-1)
    got = (*A.flash_dq(q, k, v, 1.0, beta, tau, mask, group, dsp, lse, di),
           *A.flash_dkv(q, k, v, 1.0, beta, tau, mask, group, dsp, lse, di))
    torch.cuda.synchronize()
    want = (*A.flash_dq_plain(q, k, v, 1.0, beta, tau, mask, group, dsp,
                              lse, di),
            *A.flash_dkv_plain(q, k, v, 1.0, beta, tau, mask, group, dsp,
                               lse, di))
    for g, w in zip(got, want):
        assert torch.all(torch.isfinite(g))
        assert scaled_err(g, w) < 1e-4
    assert (A.flash_fwd.launches, A.flash_dq.launches,
            A.flash_dkv.launches) == (before[0] + 2, before[1] + 1,
                                      before[2] + 1)


@pytest.mark.parametrize("shape", [FLASH_SHAPES[0], FLASH_SHAPES[-2],
                                   FLASH_SHAPES[-1]])
def test_flash_backward_kernels_repeat_bitwise(dev, shape):
    """dq, dτ's partials, dk and dv of two launches on the same inputs
    are equal bit for bit, with the other side cut into parts or not."""
    from hyperspace_torch.kernels import attention as A

    b, group, nq, nk, d, masked, empty = shape
    rng = np.random.default_rng(nq + nk + d + 1)
    q, k, v, beta, tau, mask = attention_case(rng, dev, b, group, nq, nk, d,
                                              masked, empty)
    out, lse, _ = A.flash_fwd(q, k, v, 1.0, beta, tau, mask, group)
    dsp = torch.as_tensor(rng.standard_normal(tuple(out.shape)),
                          dtype=torch.float32, device=dev)
    di = torch.sum(dsp * out, dim=-1)
    args = (q, k, v, 1.0, beta, tau, mask, group, dsp, lse, di)
    first = (*A.flash_dq(*args), *A.flash_dkv(*args))
    again = (*A.flash_dq(*args), *A.flash_dkv(*args))
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a, b_)


def test_flash_attention_gradients_match_dense_twin(dev):
    """The Function on the card (three kernels) against autograd of the
    dense twin on the card: q, k, v, τ and c; dβ exactly 0."""
    from hyperspace_torch.kernels import attention as A

    rng = np.random.default_rng(9)
    q, k, v = (hyperboloid_rows(rng, (2, 3, n, 17), dev) for n in (40, 50,
                                                                   50))
    m = torch.as_tensor(rng.random((2, 1, 40, 50)) > 0.3, device=dev)
    m[:, :, 7] = False
    g_out = torch.randn(q.shape, device=dev)
    beta0 = torch.as_tensor(rng.standard_normal((3, 1, 1)) * 0.3,
                            dtype=torch.float32, device=dev)
    tau0 = torch.as_tensor(1.0 + rng.random((3, 1, 1)), dtype=torch.float32,
                           device=dev)
    grads = []
    for fn in ("kernel", "twin"):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        c = torch.tensor(1.3, device=dev, requires_grad=True)
        beta, tau = (t.clone().requires_grad_() for t in (beta0, tau0))
        if fn == "kernel":
            out = A.flash_attention(*ins, c, beta=beta, tau=tau, mask=m)
        else:
            out = A.flash_attention_plain(*ins, c, beta, tau, m)
        (out * g_out).sum().backward()
        grads.append([t.grad for t in (*ins, tau, c, beta)])
    for name, g, w in zip("q k v tau c".split(), grads[0], grads[1]):
        assert scaled_err(g, w) < 2e-3, name
    assert torch.all(grads[0][5] == 0)


@pytest.mark.parametrize("n,k,d,tile", [
    # the pair kernel (few logits): HyboNet's heads and small cases
    (256, 8, 128, False), (64, 4, 128, False), (37, 5, 10, False),
    (3, 300, 33, False), (2, 8, 64, False), (517, 1, 32, False),
    (77, 40, 200, False), (5, 1, 200, False),
    (300, 40, 2000, False),       # rows too wide for the tiles' staging
    # the tile kernel: HGCN node classification's head (ogbn-arxiv: 40
    # classes, ball d 32), a row count off the block's 8 tiles of 16, K =
    # 1, d = 200 (the depth split across 8 warps), 300 classes (5 chunks,
    # the depth split across 2 warps, d off a multiple of 4)
    (169343, 40, 32, True), (1003, 40, 32, True), (20000, 1, 32, True),
    (1003, 40, 200, True), (1003, 300, 33, True)])
def test_hyp_mlr_kernel_matches_plain(dev, n, k, d, tile):
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain, mlr_plan

    assert mlr_plan(n, k, d).tile == tile

    rng = np.random.default_rng(n + k)

    def ball(m, s):
        v = rng.standard_normal((m, d))
        v *= rng.uniform(0.0, s, (m, 1)) / np.linalg.norm(v, axis=1,
                                                          keepdims=True)
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    x, p = ball(n, 0.9), ball(k, 0.5)
    a = torch.as_tensor(rng.standard_normal((k, d)), dtype=torch.float32,
                        device=dev)
    before = hyp_mlr.launches
    got = hyp_mlr(x, p, a, 1.0)
    again = hyp_mlr(x, p, a, 1.0)
    torch.cuda.synchronize()
    assert hyp_mlr.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, hyp_mlr_plain(x, p, a, 1.0), rtol=1e-4,
                               atol=1e-5)


def test_hyp_mlr_plan_models_the_kernels_shared_memory(dev):
    # the wrapper chooses the class chunk from its model of the tile
    # block's shared memory; the kernel sizes the block itself
    import ctypes

    from hyperspace_torch.kernels import _support as S
    from hyperspace_torch.kernels import mlr as M

    fn = S.library("mlr").hs_hyp_mlr_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for d in (1, 15, 16, 17, 32, 33, 64, 200, 1024, 1700, 2000):
        for kc in range(8, M.MAX_CHUNK + 1, 8):
            for splits in (1, 2, 4, 8):
                assert fn(kc, splits, d) == M.mlr_smem(kc, splits, d)
    optin = torch.cuda.get_device_properties(dev)
    optin = getattr(optin, "shared_memory_per_block_optin", M.SMEM_CAP)
    assert M.SMEM_CAP <= optin
    # a plan the card cannot hold is refused, not launched
    x = torch.zeros((16, 2000), device=dev)
    out = torch.empty((16, 64), device=dev)
    hs = S.function("mlr", "hs_hyp_mlr", [
        ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p])
    w = torch.zeros((64, 2000), device=dev)
    c = torch.ones(1, device=dev)       # the kernel reads c on the device
    err = hs(x.data_ptr(), w.data_ptr(), w.data_ptr(), out.data_ptr(), 16,
             64, 2000, c.data_ptr(), 1, 64, 1, S.stream_ptr(x))
    assert err != 0


def test_hybonet_kernels_refuse_what_they_do_not_take(dev):
    from hyperspace_torch.kernels import attention as A
    from hyperspace_torch.kernels.mlr import hyp_mlr

    x = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        hyp_mlr(x, x, x, 1.0)
    q = torch.zeros((2, 5, 80), device=dev)
    one = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="width 80"):
        A.flash_fwd(q, q, q, 1.0, one, one)
    q = torch.zeros((2, 5, 9), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        A.flash_fwd(q, q, q, 1.0, one.double(), one.double())


def test_hybonet_step_on_the_card_matches_the_cpu(dev):
    """Two HyboNet steps from the same parameters and batches, card
    against CPU, all f32: losses within rtol 1e-4."""
    from hyperspace_torch.data.text import synthetic_text
    from hyperspace_torch.models import hybonet

    ds = synthetic_text(num_samples=64, vocab_size=128, num_classes=3,
                        max_len=24, min_len=4, seed=3)
    cfg = hybonet.HyboNetConfig(vocab_size=128, num_classes=3, max_len=24,
                                dim=32, num_heads=2, num_layers=2,
                                batch_size=16)
    runs = {}
    for where in ("cpu", "cuda"):
        model, opt, state = hybonet.init_model(cfg, seed=0, device=where)
        losses = []
        for i in range(2):
            sl = slice(16 * i, 16 * i + 16)
            t, m, y = (torch.as_tensor(a[sl], device=where)
                       for a in (ds.tokens, ds.mask, ds.labels))
            state, loss = hybonet.train_step(model, opt, state, t, m, y)
            losses.append(float(loss))
        runs[where] = losses
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)


# --- the Poincaré row-wise ops and hyp_linear --------------------------------
# f32 kernel against the f32 plain version: rtol 2e-4, atol 2e-5 (the
# JAX package's tier for these kernels: log-form transcendentals, other
# summation orders); hyp_linear atol 2e-4 (its tier).  bf16: within one
# bf16 ulp of the f32 plain version on the same (bf16) inputs, plus the
# f32 tier (the output rounds once; a rounding flip moves it one ulp).

ROW_OPS = ("mobius_add", "mobius_scalar_mul", "expmap", "logmap", "expmap0",
           "logmap0", "ptransp")


def ball_rows(rng, shape, c, dev, scale=0.8):
    v = rng.standard_normal(shape)
    v = v / (1.0 + np.linalg.norm(v, axis=-1, keepdims=True))
    return torch.as_tensor(v * scale / np.sqrt(c), dtype=torch.float32,
                           device=dev)


def row_args(rng, op, shape, c, dev):
    x = ball_rows(rng, shape, c, dev)
    y = ball_rows(rng, shape, c, dev, 0.5)
    v = torch.as_tensor(rng.standard_normal(shape) * 0.3,
                        dtype=torch.float32, device=dev)
    return {"mobius_add": (x, y), "mobius_scalar_mul": (x,),
            "expmap": (x, v), "logmap": (x, y), "expmap0": (v,),
            "logmap0": (y,), "ptransp": (x, y, v)}[op]


def call_row(op, tensors, c, r=0.7, plain=False):
    from hyperspace_torch.kernels import pointwise as PW

    fn = getattr(PW, op + "_plain" if plain else op)
    return fn(r, *tensors, c) if op == "mobius_scalar_mul" else fn(*tensors,
                                                                   c)


def assert_bf16_close(got, want32, rtol, atol):
    assert got.dtype == torch.bfloat16
    g = got.float()
    _, e = torch.frexp(want32)
    ulp = torch.ldexp(torch.ones_like(want32), (e - 8).to(torch.int32))
    tol = ulp + atol + rtol * want32.abs()
    assert bool(((g - want32).abs() <= tol).all()), float(
        (g - want32).abs().max())


@pytest.mark.parametrize("c", [1.0, 0.5, 2.3])
@pytest.mark.parametrize("shape", [(40, 10), (130, 7), (9, 128), (17, 200),
                                   (3, 8, 48), (2, 1), (5, 10), (1003, 8),
                                   (70, 16), (82115, 10)])
@pytest.mark.parametrize("op", ROW_OPS)
def test_rowwise_kernels_match_plain(dev, op, shape, c):
    from hyperspace_torch.kernels import pointwise as PW

    rng = np.random.default_rng(sum(shape))
    ts = row_args(rng, op, shape, c, dev)
    fn = getattr(PW, op)
    before = fn.launches
    got = call_row(op, ts, c)
    again = call_row(op, ts, c)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, call_row(op, ts, c, plain=True),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("r", [-1.5, 0.0, 0.5, 3.0])
def test_mobius_scalar_mul_kernel_r(dev, r):
    rng = np.random.default_rng(1)
    x = ball_rows(rng, (300, 10), 0.7, dev)
    torch.testing.assert_close(call_row("mobius_scalar_mul", (x,), 0.7, r),
                               call_row("mobius_scalar_mul", (x,), 0.7, r,
                                        plain=True), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(500, 48), (1003, 10), (29, 8), (64, 5)])
@pytest.mark.parametrize("op", ROW_OPS)
def test_rowwise_kernels_bf16(dev, op, shape):
    rng = np.random.default_rng(2)
    ts = [t.to(torch.bfloat16) for t in row_args(rng, op, shape, 1.0, dev)]
    got = call_row(op, ts, 1.0)
    want = call_row(op, [t.float() for t in ts], 1.0, plain=True)
    assert_bf16_close(got, want, 2e-4, 2e-5)
    assert torch.equal(got, call_row(op, ts, 1.0))


@pytest.mark.parametrize("d", range(1, 17))
@pytest.mark.parametrize("op", ROW_OPS)
def test_rowwise_narrow_rows_match_plain(dev, op, d):
    """Every width of the packed kernel (a lane a row, a warp 32 rows),
    f32, bf16 and bf16 first with f32 after (read as f32, written as
    bf16), at n below 32 and off a multiple of 32; repeats bitwise."""
    from hyperspace_torch.kernels import pointwise as PW

    fn = getattr(PW, op)
    for n in (5, 1003):
        rng = np.random.default_rng(100 * n + d)
        ts = row_args(rng, op, (n, d), 0.7, dev)
        kinds = [("f32", ts), ("bf16", [t.to(torch.bfloat16) for t in ts])]
        if len(ts) > 1:
            kinds.append(("bf16 first",
                          [ts[0].to(torch.bfloat16), *ts[1:]]))
        for kind, xs in kinds:
            before = fn.launches
            got, again = call_row(op, xs, 0.7), call_row(op, xs, 0.7)
            torch.cuda.synchronize()
            assert fn.launches == before + 2
            assert torch.equal(got, again), (kind, n)
            want = call_row(op, [t.float() for t in xs], 0.7, plain=True)
            if kind == "f32":
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            else:
                assert_bf16_close(got, want, 2e-4, 2e-5)


@pytest.mark.parametrize("d", [3, 8, 10, 16])
def test_rowwise_narrow_rows_broadcast_operands(dev, d):
    """A [d] operand (row stride 0, read once a block) in each place of
    the multi-operand ops, f32 and bf16, beside n = 1003 rows."""
    from hyperspace_torch.kernels import pointwise as PW

    rng = np.random.default_rng(d)
    x = ball_rows(rng, (1003, d), 1.0, dev)
    y = ball_rows(rng, (1003, d), 1.0, dev, 0.5)
    b = ball_rows(rng, (d,), 1.0, dev, 0.3)
    v = torch.as_tensor(rng.standard_normal((1003, d)) * 0.3,
                        dtype=torch.float32, device=dev)
    for op, ts in (("mobius_add", (x, b)), ("mobius_add", (b, x)),
                   ("expmap", (x, b)), ("logmap", (b, y)),
                   ("ptransp", (x, b, v)), ("ptransp", (b, y, v[0]))):
        for dt in (torch.float32, torch.bfloat16):
            xs = [t.to(dt) for t in ts]
            got = call_row(op, xs, 1.0)
            assert got.shape == (1003, d)
            assert torch.equal(got, call_row(op, xs, 1.0))
            want = call_row(op, [t.float() for t in xs], 1.0, plain=True)
            if dt == torch.float32:
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            else:
                assert_bf16_close(got, want, 2e-4, 2e-5)
    assert PW.mobius_add(b, b, 1.0).shape == (d,)


@pytest.mark.parametrize("n", [64, 5, 1003])
def test_rowwise_kernels_broadcast_margin_and_zero_rows(dev, n):
    from hyperspace_torch.kernels import pointwise as PW

    rng = np.random.default_rng(3)
    x = ball_rows(rng, (n, 10), 1.0, dev)
    b = ball_rows(rng, (10,), 1.0, dev, 0.3)
    for y in (b, b[None, None, :].expand(2, n, 10)):
        torch.testing.assert_close(PW.mobius_add(x, y, 1.0),
                                   PW.mobius_add_plain(x, y, 1.0),
                                   rtol=2e-4, atol=2e-5)
    big = torch.as_tensor(rng.standard_normal((n, 10)) * 40.0,
                          dtype=torch.float32, device=dev)
    x[3] = 0.0
    big[n // 3] = 0.0
    big[n - 1] = 0.0
    for op, ts in (("expmap", (x, big)), ("expmap0", (big,)),
                   ("logmap0", (x,)), ("mobius_add", (x, x)),
                   ("logmap", (x, x)), ("ptransp", (x, x, big))):
        got = call_row(op, ts, 1.3)
        assert torch.equal(got, call_row(op, ts, 1.3))
        torch.testing.assert_close(got, call_row(op, ts, 1.3, plain=True),
                                   rtol=2e-4, atol=2e-5)
    edge = PW.expmap0(big, 1.3)
    assert float(torch.linalg.norm(edge, dim=-1).max()) < 1 / np.sqrt(1.3)


@pytest.mark.parametrize("op", ROW_OPS)
def test_rowwise_gradients_match_plain_autograd(dev, op):
    """The Function's backward (autograd of the plain version) to every
    tensor, a device tensor c and a device tensor r."""
    rng = np.random.default_rng(4)
    ts = [t.requires_grad_() for t in row_args(rng, op, (50, 12), 0.8, dev)]
    c = torch.tensor(0.8, device=dev, requires_grad=True)
    r = torch.tensor(1.3, device=dev, requires_grad=True)
    w = torch.randn((50, 12), device=dev)
    got = torch.autograd.grad((call_row(op, ts, c, r) * w).sum(),
                              ts + [c, r], allow_unused=True)
    want = torch.autograd.grad((call_row(op, ts, c, r, plain=True)
                                * w).sum(), ts + [c, r], allow_unused=True)
    for a, b in zip(got, want):
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0
            continue
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def linear_args(rng, n, d_in, d_out, dev):
    x = ball_rows(rng, (n, d_in), 1.0, dev)
    m = torch.as_tensor(rng.standard_normal((d_in, d_out)) * 0.3,
                        dtype=torch.float32, device=dev)
    b = ball_rows(rng, (d_out,), 1.0, dev, 0.3)
    return x, m, b


@pytest.mark.parametrize("n,d_in,d_out", [(256, 48, 32), (1000, 128, 128),
                                          (777, 130, 200), (5, 7, 3),
                                          (300, 1000, 700),
                                          # rows past a whole row tile; the
                                          # path widths at a few thousand rows
                                          (1001, 128, 128), (4099, 128, 32),
                                          (3000, 128, 128), (333, 48, 64),
                                          (70, 129, 17)])
@pytest.mark.parametrize("c", [1.0, 0.5])
def test_hyp_linear_kernel_matches_plain(dev, n, d_in, d_out, c):
    from hyperspace_torch.kernels.hyplinear import hyp_linear, hyp_linear_plain

    rng = np.random.default_rng(n + d_in)
    x, m, b = linear_args(rng, n, d_in, d_out, dev)
    m = m / np.sqrt(d_in / 16.0)
    x[1] = 0.0                      # ‖x‖ = 0 → M x = 0 → b
    before = hyp_linear.launches
    got = hyp_linear(x, m, b, c)
    again = hyp_linear(x, m, b, c)
    torch.cuda.synchronize()
    assert hyp_linear.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, hyp_linear_plain(x, m, b, c), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(got[1], b, rtol=1e-5, atol=1e-6)
    zero = torch.zeros(d_out, device=dev)
    torch.testing.assert_close(hyp_linear(x, m, zero, c),
                               hyp_linear_plain(x, m, zero, c), rtol=2e-4,
                               atol=2e-4)


def test_hyp_linear_kernel_bf16_margin_and_leading_dims(dev):
    from hyperspace_torch.kernels.hyplinear import hyp_linear, hyp_linear_plain

    rng = np.random.default_rng(5)
    x, m, b = linear_args(rng, 600, 128, 32, dev)
    xb = x.to(torch.bfloat16)
    assert_bf16_close(hyp_linear(xb, m, b, 1.0),
                      hyp_linear_plain(xb.float(), m, b, 1.0), 2e-4, 2e-4)
    big = hyp_linear(x, 30.0 * m, b, 1.0)       # rows pinned at the margin
    torch.testing.assert_close(big, hyp_linear_plain(x, 30.0 * m, b, 1.0),
                               rtol=2e-4, atol=2e-4)
    x3 = x[:24].reshape(3, 8, 128)
    got = hyp_linear(x3, m, b, 1.0)
    assert got.shape == (3, 8, 32)
    torch.testing.assert_close(got, hyp_linear_plain(x3, m, b, 1.0),
                               rtol=2e-4, atol=2e-4)
    zm = torch.zeros_like(m)                   # M x = 0 on every row
    torch.testing.assert_close(hyp_linear(x, zm, b, 1.0),
                               b.expand(600, 32), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,d_out", [(4099, 32), (3000, 128)])
def test_hyp_linear_kernel_bf16_path_widths(dev, n, d_out):
    from hyperspace_torch.kernels.hyplinear import hyp_linear, hyp_linear_plain

    rng = np.random.default_rng(n)
    x, m, b = linear_args(rng, n, 128, d_out, dev)
    m = m / np.sqrt(128 / 16.0)
    xb = x.to(torch.bfloat16)
    got = hyp_linear(xb, m, b, 1.0)
    assert torch.equal(got, hyp_linear(xb, m, b, 1.0))
    assert_bf16_close(got, hyp_linear_plain(xb.float(), m, b, 1.0), 2e-4,
                      2e-4)


def test_hyp_linear_gradients_match_plain_autograd(dev):
    from hyperspace_torch.kernels.hyplinear import hyp_linear, hyp_linear_plain

    rng = np.random.default_rng(6)
    ins = [t.requires_grad_() for t in linear_args(rng, 200, 40, 24, dev)]
    c = torch.tensor(0.9, device=dev, requires_grad=True)
    w = torch.randn((200, 24), device=dev)
    got = torch.autograd.grad((hyp_linear(*ins, c) * w).sum(), ins + [c])
    want = torch.autograd.grad((hyp_linear_plain(*ins, c) * w).sum(),
                               ins + [c])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_poincare_kernels_refuse_what_they_do_not_take(dev):
    from hyperspace_torch.kernels import flash_attention
    from hyperspace_torch.kernels import pointwise as PW
    from hyperspace_torch.kernels.hyplinear import hyp_linear

    x = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PW.mobius_add(x, x, 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        hyp_linear(x, torch.zeros((3, 2), device=dev),
                   torch.zeros(2, device=dev), 1.0)
    with pytest.raises(ValueError, match="scalar"):
        PW.expmap0(x.float(), torch.ones(2, device=dev))
    q = torch.ones((2, 5, 4), device=dev)
    with pytest.raises(ValueError, match="per \\(batch, head\\) only"):
        flash_attention(q, q, q, 1.0, beta=torch.zeros((2, 5, 5),
                                                      device=dev))
    with pytest.raises(ValueError, match="per \\(batch, head\\) only"):
        flash_attention(q, q, q, 1.0, tau=torch.ones((2, 5, 1), device=dev))


def test_gyro_stack_on_the_card_matches_the_cpu(dev):
    """HypLinear → HypAct(c 1 → 0.5) → HypLinear from the same parameters,
    card against CPU, f32: loss and gradients within rel 1e-4."""
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.nn import HypAct, HypLinear

    rng = np.random.default_rng(7)
    x = ball_rows(rng, (500, 64), 1.0, "cpu", 0.5)
    tgt = ball_rows(rng, (500, 16), 0.5, "cpu", 0.5)
    g = torch.Generator().manual_seed(0)
    stack = torch.nn.Sequential(HypLinear(64, 64, PoincareBall(1.0),
                                          generator=g),
                                HypAct(PoincareBall(1.0), PoincareBall(0.5)),
                                HypLinear(64, 16, PoincareBall(0.5),
                                          generator=g))
    res = {}
    for where in ("cpu", "cuda"):
        model = copy.deepcopy(stack).to(where)
        loss = torch.mean(PoincareBall(0.5).sqdist(model(x.to(where)),
                                                   tgt.to(where)))
        loss.backward()
        res[where] = [float(loss.detach())] + [
            p.grad.detach().cpu().clone() for p in model.parameters()]
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-4)
    for a, b in zip(res["cuda"][1:], res["cpu"][1:]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# --- the Poincaré-embedding path (RSGD / RAdam) ------------------------------

PE_ROWS, PE_SLOTS = 66_430, 12_288


def _pe_ball(gen, shape, dev, radius=0.8):
    from hyperspace_torch.manifolds import PoincareBall

    v = torch.randn(shape, generator=gen, device=dev) * (
        radius / np.sqrt(shape[-1]))
    return PoincareBall(1.0).expmap0(v).contiguous()


def test_pe_pdist_at_the_evaluation_shape(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    table = _pe_ball(gen, (PE_ROWS, 10), dev)
    u = torch.randint(0, PE_ROWS, (1024,), generator=gen, device=dev)
    q = table[u].contiguous()
    got = pdist(q, table, 1.0, manifold="poincare")
    assert torch.equal(got, pdist(q, table, 1.0, manifold="poincare"))
    want = pdist_plain(q, table, 1.0, manifold="poincare")
    # queries are table rows, as in evaluate: the self column (d = 0, the
    # Gram form's rounding noise) is held apart, within 1e-2
    rows = torch.arange(1024, device=dev)
    assert float((got - want)[rows, u].abs().max()) <= 1e-2
    got[rows, u] = want[rows, u]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_pe_scan_topk_on_a_mining_pool_with_duplicates(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    table = _pe_ball(gen, (PE_ROWS, 10), dev)
    ids = torch.randint(0, PE_ROWS, (64,), generator=gen, device=dev)
    ids[40:48] = ids[:8]
    pool = table[ids].contiguous()
    q = table[:1024].contiguous()
    qi = torch.zeros(1024, dtype=torch.int32, device=dev)
    d1, i1 = scan_topk(pool, q, qi, 0, spec=("poincare", 1.0), k=10, n=64)
    d1b, i1b = scan_topk(pool, q, qi, 0, spec=("poincare", 1.0), k=10, n=64)
    assert torch.equal(d1, d1b) and torch.equal(i1, i1b)
    d2, i2 = scan_topk_plain(pool, q, qi, 0, kind="poincare", c=1.0, k=10,
                             n=64, exclude_self=False)
    assert topk_disagreements(i1.cpu().numpy(), d1.cpu().numpy(),
                              i2.cpu().numpy(), d2.cpu().numpy(),
                              rtol=RTOL, atol=ATOL) == 0
    for row in i1.cpu().numpy():        # the lower slot of a tie first
        for a in range(8):
            pa, pb = np.flatnonzero(row == a), np.flatnonzero(row == 40 + a)
            assert not len(pb) or (len(pa) and pa[0] < pb[0])


@pytest.mark.parametrize("op,n", [("expmap", PE_ROWS), ("expmap", PE_SLOTS),
                                  ("ptransp", 597_871),
                                  ("ptransp", PE_SLOTS)])
def test_pe_row_ops_at_the_update_shapes(dev, op, n):
    from hyperspace_torch import kernels as K
    from hyperspace_torch.kernels import pointwise as PW

    gen = torch.Generator(device=dev).manual_seed(n)
    x = _pe_ball(gen, (n, 10), dev)
    y = _pe_ball(gen, (n, 10), dev, 0.5)
    v = torch.randn((n, 10), generator=gen, device=dev) * 0.2
    args = (x, v) if op == "expmap" else (x, y, v)
    got = getattr(K, op)(*args, 1.0)
    assert torch.equal(got, getattr(K, op)(*args, 1.0))
    want = getattr(PW, op + "_plain")(*args, 1.0)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_pe_segment_sum_at_the_planned_shape(dev):
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe

    ds = synthetic_tree(5, 9)
    cfg = pe.PoincareEmbedConfig(num_nodes=ds.num_nodes, batch_size=1024)
    plan = pe.plan_sparse_steps(cfg, ds.pairs, 2, device=dev)
    recv = plan.seg_sorted[1].contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    vals = torch.randn(PE_SLOTS, 10, generator=gen, device=dev)
    got = csr_segment_sum(vals, recv, None, PE_SLOTS)
    assert torch.equal(got, csr_segment_sum(vals, recv, None, PE_SLOTS))
    torch.testing.assert_close(
        got, csr_segment_sum_plain(vals, recv, PE_SLOTS), rtol=1e-5,
        atol=1e-5)


def _pe_clone(state):
    import torch.utils._pytree as pytree

    def one(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        return x.clone() if isinstance(x, torch.Tensor) else x

    return pytree.tree_map(one, state)


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
@pytest.mark.parametrize("path", ["dense", "mined", "planned"])
def test_pe_graphed_epoch_equals_eager_steps(dev, optimizer, path):
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe

    ds = synthetic_tree(4, 6)
    cfg = pe.PoincareEmbedConfig(
        num_nodes=ds.num_nodes, dim=10, batch_size=256, neg_samples=10,
        optimizer=optimizer, burnin_steps=5,
        neg_mode="mined" if path == "mined" else "uniform")
    pairs = torch.as_tensor(ds.pairs, dtype=torch.int64, device=dev)
    st, opt = pe.init_state(cfg, 3, dev)
    if path == "planned":
        plan = pe.plan_sparse_steps(cfg, ds.pairs, 12, device=dev)
        st = pe.pack_state(cfg, st)
    eager = _pe_clone(st)
    for _ in range(2):                       # the second chunk replays
        if path == "planned":
            st, losses = pe.train_epoch_planned_packed(cfg, opt, st, plan)
        else:
            st, losses = pe.train_epoch_scan(cfg, opt, st, pairs, 12)
        steps = []
        for _ in range(12):
            if path == "planned":
                eager, loss = pe.train_step_planned_packed(cfg, opt, eager,
                                                           plan)
            else:
                eager, loss = pe.train_step(cfg, opt, eager, pairs)
            steps.append(loss)
        assert torch.equal(st[0], eager[0])
        assert torch.equal(losses, torch.stack(steps))


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
@pytest.mark.parametrize("path", ["dense", "mined", "sparse", "planned",
                                  "packed"])
def test_pe_steps_on_the_card_match_the_cpu(dev, optimizer, path):
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe

    ds = synthetic_tree(3, 3)
    cfg = pe.PoincareEmbedConfig(
        num_nodes=ds.num_nodes, dim=5, batch_size=48, neg_samples=6,
        burnin_steps=2, optimizer=optimizer,
        neg_mode="mined" if path == "mined" else "uniform")
    rng = np.random.default_rng(4)
    u = ds.pairs[rng.integers(0, ds.num_pairs, (5, 48))]
    neg = rng.integers(0, ds.num_nodes, (5, 48, 6))
    pools = rng.integers(0, ds.num_nodes, (5, 64))
    tab = rng.standard_normal((ds.num_nodes, 5))
    tab = (tab / np.linalg.norm(tab, axis=1, keepdims=True)
           * rng.uniform(0.05, 0.6, (ds.num_nodes, 1))).astype(np.float32)
    out = {}
    for where in (dev, torch.device("cpu")):
        st, opt = pe.init_state(cfg, 0, where)
        st = st._replace(table=torch.as_tensor(tab, device=where))
        plan = pe.plan_from_indices(cfg, u[..., 0], u[..., 1], neg,
                                    device=where)
        if path == "packed":
            st = pe.pack_state(cfg, st)
        for i in range(5):
            ids = [torch.as_tensor(a, device=where)
                   for a in (u[i, :, 0], u[i, :, 1], neg[i])]
            if path in ("dense", "mined"):
                st, _ = pe.step_on_batch(
                    cfg, opt, st, *ids[:2],
                    neg_idx=ids[2] if path == "dense" else None,
                    pool_idx=torch.as_tensor(pools[i], device=where))
            elif path == "sparse":
                st, _ = pe.sparse_step_on_batch(cfg, opt, st, *ids)
            elif path == "planned":
                st, _ = pe.train_step_sparse_planned(cfg, opt, st, plan)
            else:
                st, _ = pe.train_step_planned_packed(cfg, opt, st, plan)
        out[where.type] = st[0].cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-4 * float(out["cpu"].abs().max()))


# --- HGCN node classification and the hyperbolic VAE -------------------------


def test_hyp_mlr_at_the_nc_heads_input(dev):
    """The NC head's input as the path makes it: 33-wide hyperboloid
    points mapped to the 32-d ball, 40 hyperplanes from origin tangents
    (``LorentzMLR``), at [169,343, 40, 32]; twice for the same bits."""
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.manifolds.maps import lorentz_to_ball

    rng = np.random.default_rng(17)
    z = hyperboloid_rows(rng, (169343, 33), dev)
    xb = lorentz_to_ball(z, 1.0).contiguous()
    p = PoincareBall(1.0).expmap0(torch.as_tensor(
        rng.standard_normal((40, 32)) * 0.1, dtype=torch.float32,
        device=dev))
    a = torch.as_tensor(rng.standard_normal((40, 32)) * 0.3,
                        dtype=torch.float32, device=dev)
    before = hyp_mlr.launches
    got = hyp_mlr(xb, p, a, 1.0)
    again = hyp_mlr(xb, p, a, 1.0)
    torch.cuda.synchronize()
    assert hyp_mlr.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, hyp_mlr_plain(xb, p, a, 1.0), rtol=1e-4,
                               atol=1e-5)


def _nc_graph(n=600, classes=5):
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels.cluster import build_cluster_split

    edges, x, labels, _ = G.synthetic_hierarchy(
        num_nodes=n, feat_dim=12, num_classes=classes, seed=0)
    tr, va, te = G.node_split_masks(n, seed=0)
    g = G.prepare(edges, n, x, pad_multiple=256, cluster=False,
                  labels=labels, num_classes=classes, train_mask=tr,
                  val_mask=va, test_mask=te)
    g.cluster_split = build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, n, min_pair_edges=8,
        rev_perm=g.rev_perm)
    assert 0.1 < g.cluster_split.frac_clustered < 1.0
    return g


def test_nc_step_launch_counts_are_exact(dev):
    """A step: 4 ``csr_segment_sum`` (2 layers' stragglers, forward and
    backward), 4 ``cluster_aggregate``, 1 ``hyp_mlr`` (the head's
    forward); an evaluation half the scatters and 1 ``hyp_mlr``; no row
    plan built in either."""
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.kernels import cluster as KC
    from hyperspace_torch.kernels.mlr import hyp_mlr
    from hyperspace_torch.models import hgcn

    g = _nc_graph()
    cfg = hgcn.HGCNConfig(feat_dim=12, hidden_dims=(16, 8), num_classes=5,
                          agg_dtype=torch.bfloat16)
    model, opt, state = hgcn.init_nc(cfg, g, seed=0, device=dev)
    ga = G.to_device(g, dev)
    labels, train = hgcn.nc_targets(g, dev)
    fns = (csr_segment_sum, KC.cluster_aggregate, hyp_mlr)

    def counts():
        return [f.launches for f in fns] + [KC.row_plan_builds]

    before = counts()
    for _ in range(3):
        state, loss = hgcn.train_step_nc(model, opt, state, ga, labels, train)
    after = counts()
    assert [b - a for a, b in zip(before, after)] == [12, 12, 3, 0]
    assert torch.isfinite(loss)
    hgcn.evaluate_nc(model, g, ga=ga)
    assert [b - a for a, b in zip(after, counts())] == [2, 2, 1, 0]


def test_nc_steps_on_the_card_match_the_cpu(dev):
    from hyperspace_torch.models import hgcn

    g = _nc_graph()
    cfg = hgcn.HGCNConfig(feat_dim=12, hidden_dims=(16, 8), num_classes=5)
    out = {}
    for where in (dev, torch.device("cpu")):
        model, res = hgcn.train_nc(cfg, g, steps=3, seed=2, device=where)
        out[where.type] = (res, {k: v.float().cpu() for k, v in
                                 model.state_dict().items()})
    np.testing.assert_allclose(out["cuda"][0]["loss"], out["cpu"][0]["loss"],
                               rtol=1e-4)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))


@pytest.mark.parametrize("kind", ["poincare", "lorentz"])
def test_hvae_steps_on_the_card_match_the_cpu(dev, kind):
    """Two sampled steps from the same parameters with injected ids and
    ε: loss, recon and kl within rel 1e-4, each parameter within rel
    1e-4 norm-wise (float32, cuDNN's TF32 off in the model).  Not
    element by element: Adam divides each gradient by its own root mean
    square, so an entry whose gradient cancels to rounding noise moves
    by up to lr·|noise| / (|noise| + eps) on either device."""
    from hyperspace_torch.data.mnist import synthetic_mnist
    from hyperspace_torch.models import hvae

    cfg = hvae.HVAEConfig(image_size=28, latent_dim=8, hidden=64,
                          conv_features=(16, 32), batch_size=16, kind=kind)
    images = synthetic_mnist(num_samples=64, seed=1).images
    gen = torch.Generator().manual_seed(5)
    p0 = hvae.init_params(cfg, gen)
    draws = [(torch.randint(0, 64, (16,), generator=gen),
              torch.randn((16, 8), generator=gen)) for _ in range(2)]
    out = {}
    for where in (dev, torch.device("cpu")):
        model, opt, st = hvae.init_model(cfg, 0, where, params=p0)
        x = torch.as_tensor(images, device=where)
        metrics = []
        for idx, eps in draws:
            st, *m = hvae.train_step_sampled(model, opt, st, x,
                                             idx=idx.to(where),
                                             eps=eps.to(where))
            metrics.append(torch.stack(m).cpu())
        out[where.type] = (torch.stack(metrics), st.params)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for part, layers in out["cpu"][1].items():
        for layer, leaves in layers.items():
            for name, v in leaves.items():
                got = out["cuda"][1][part][layer][name].cpu()
                gap = torch.linalg.vector_norm(got - v)
                assert gap <= 1e-4 * torch.linalg.vector_norm(v), (
                    part, layer, name, float(gap))


def _hvae_graph_and_eager(dev):
    """A graphed chunk of 4 sampled steps and the same 4 steps run
    eagerly from the same state: (graphed metrics, eager metrics, graphed
    parameters, eager parameters)."""
    from hyperspace_torch.data.mnist import synthetic_mnist
    from hyperspace_torch.models import hvae
    from hyperspace_torch.train import loop

    cfg = hvae.HVAEConfig(latent_dim=8, hidden=64, conv_features=(16, 32),
                          batch_size=16, kind="lorentz")
    x = torch.as_tensor(synthetic_mnist(num_samples=64, seed=2).images,
                        device=dev)
    model, opt, st = hvae.init_model(cfg, 3, dev)
    eager = _pe_clone(st)
    rows_ = []
    for _ in range(4):
        eager, *m = hvae.train_step_sampled(model, opt, eager, x)
        rows_.append(torch.stack(m))
    chunk = loop.make_chunked_stepper(hvae.chunk_step(model, opt), 4)
    st, got = chunk(st, x)
    torch.cuda.synchronize()
    return (got, torch.stack(rows_),
            torch.utils._pytree.tree_leaves(st.params),
            torch.utils._pytree.tree_leaves(eager.params))


def test_hvae_graphed_chunk_equals_eager_steps(dev):
    """Under cuDNN's determinism a graphed chunk is the eager steps bit
    for bit."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        got, want, params, eager = _hvae_graph_and_eager(dev)
    assert torch.equal(got, want)
    for a, b in zip(params, eager):
        assert torch.equal(a, b)


def test_hvae_graphed_chunk_near_eager_steps_without_determinism(dev):
    """As the path runs (cuDNN's determinism off, its weight gradients
    summed in another order each run), a graphed chunk stays within rel
    1e-5 of the eager steps: metrics entry-wise, parameters norm-wise."""
    assert not torch.backends.cudnn.deterministic
    got, want, params, eager = _hvae_graph_and_eager(dev)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    for a, b in zip(params, eager):
        assert torch.linalg.vector_norm(a - b) <= 1e-5 * \
            torch.linalg.vector_norm(b)


# --- learned curvature, graph_edge_sqdist and the CLI's paths ---------------


@pytest.mark.parametrize("n,k,d,tile", [(256, 8, 128, False),
                                        (169343, 40, 32, True),
                                        (1003, 300, 33, True)])
def test_hyp_mlr_with_a_device_curvature(dev, n, k, d, tile):
    """Both plans read c from device memory: a 0-d tensor (a learned
    curvature) gives the bits of the same number passed as a Python
    float, logits within the kernel's tier (rtol 1e-4, atol 1e-5) of the
    float64 plain version (at c = 0.8 the f32 plain version is at 0.80 of
    that tier here, so kernel and plain may differ by more than one tier
    on a few logits), and the plain version's dc (the backward is its
    VJP) through the kernel."""
    from hyperspace_torch.kernels.mlr import hyp_mlr, hyp_mlr_plain, mlr_plan

    assert mlr_plan(n, k, d).tile == tile
    rng = np.random.default_rng(n + 3 * k)
    c = 0.8

    def ball(m, s):
        v = rng.standard_normal((m, d))
        v *= rng.uniform(0.0, s, (m, 1)) / np.linalg.norm(v, axis=1,
                                                          keepdims=True)
        return torch.as_tensor(v / np.sqrt(c), dtype=torch.float32,
                               device=dev)

    x, p = ball(n, 0.9), ball(k, 0.5)
    a = torch.as_tensor(rng.standard_normal((k, d)), dtype=torch.float32,
                        device=dev)
    ct = torch.tensor(c, device=dev, requires_grad=True)
    before = hyp_mlr.launches
    got = hyp_mlr(x, p, a, ct)
    again = hyp_mlr(x, p, a, ct.detach())
    number = hyp_mlr(x, p, a, c)
    torch.cuda.synchronize()
    assert hyp_mlr.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, number)
    c2 = ct.detach().clone().requires_grad_()
    want = hyp_mlr_plain(x, p, a, c2)
    f64 = hyp_mlr_plain(x.double(), p.double(), a.double(), c)
    torch.testing.assert_close(got.detach().double(), f64, rtol=1e-4,
                               atol=1e-5)
    g = torch.randn(got.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n))
    (dc,) = torch.autograd.grad(got, ct, g)
    (dc_plain,) = torch.autograd.grad(want, c2, g)
    assert torch.equal(dc, dc_plain) and torch.isfinite(dc)
    with pytest.raises(ValueError, match="one value"):
        hyp_mlr(x, p, a, torch.tensor(c))            # c on the host


def test_graph_edge_sqdist_scatter_matches_plain(dev):
    """graph_edge_sqdist on the card: one csr_segment_sum a backward, at
    the HGCN decoder's [E, 33] over a prepared graph's own edges, bf16
    and f32; values, dz and dc against the same Function on the CPU."""
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.manifolds import Lorentz
    from hyperspace_torch.nn.edge_dist import graph_edge_sqdist

    edges, x, _, _ = G.community_power_law_graph(3000, 20000, 7, 8, seed=2)
    g = G.prepare(edges, 3000, x, pad_multiple=1024, cache=False)
    rng = np.random.default_rng(4)
    v = np.zeros((3000, 33))
    v[:, 1:] = rng.standard_normal((3000, 32)) * 0.3
    z64 = Lorentz(0.9).expmap0(torch.as_tensor(v))
    real = g.edge_mask & (g.senders != g.receivers)
    gbar = torch.as_tensor(rng.standard_normal(len(real)) * real)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        out = {}
        for where in ("cuda", "cpu"):
            d = torch.device(where)
            gd = G.to_device(g, d)
            z = z64.to(dt).to(d).requires_grad_()
            c = torch.tensor(0.9, device=d, requires_grad=True)
            before = csr_segment_sum.launches
            sq = graph_edge_sqdist(z, c, gd.senders, gd.receivers,
                                   gd.rev_perm, gd.plan)
            (sq * gbar.to(dt).to(d)).float().sum().backward()
            if where == "cuda":
                torch.cuda.synchronize()
                assert csr_segment_sum.launches == before + 1
            out[where] = (sq.detach().float().cpu(), z.grad.float().cpu(),
                          c.grad.float().cpu())
        for got, want in zip(out["cuda"], out["cpu"]):
            torch.testing.assert_close(got, want, rtol=tol,
                                       atol=tol * float(want.abs().max()))


def test_cli_hgcn_on_the_card(dev, tmp_path, capsys):
    """cli.train hgcn from a Cora layout on disk, learned curvature on:
    the JSON line, the native prep, finite losses."""
    import json

    from hyperspace_torch.cli import train as cli_train
    from hyperspace_torch.data import graphs as G

    edges, x, labels, _ = G.community_power_law_graph(500, 2500, 5, 16,
                                                      seed=1)
    G.write_cora_layout(str(tmp_path), edges, x, labels)
    for task in ("lp", "nc"):
        assert cli_train.main(["hgcn", f"task={task}", "dataset=cora",
                               f"data_root={tmp_path}", "steps=3",
                               "learn_c=true", "agg_dtype=bfloat16"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["task"] == task and out["prep"] == "native"
        assert np.isfinite(out["loss"])


def test_product_steps_on_the_card_match_the_cpu(dev):
    """Three product-embedding steps on given ids (collisions included)
    from one state: table norm-wise, c_raw and losses within rel 1e-4 of
    the CPU, all float32."""
    from hyperspace_torch.models import product_embed as pme

    cfg = pme.ProductEmbedConfig(num_nodes=500, batch_size=64,
                                 burnin_steps=1)
    rng = np.random.default_rng(0)
    ids = [(rng.integers(0, 500, 64), rng.integers(0, 500, 64),
            rng.integers(0, 500, (64, 10))) for _ in range(3)]
    runs = {}
    for where in ("cuda", "cpu"):
        state, opt = pme.init_state(cfg, 0, device="cpu")
        state = pme.TrainState(
            pme.Params(*(t.to(where) for t in state.params)),
            type(state.curv_opt_state)(*(t.to(where)
                                         for t in state.curv_opt_state)),
            torch.Generator(device=where), state.step.to(where))
        losses = []
        for u, v, neg in ids:
            neg[0, 0] = u[0]
            state, loss = pme.step_on_batch(
                cfg, opt, state, *(torch.as_tensor(a, device=where)
                                   for a in (u, v, neg)))
            losses.append(float(loss))
        runs[where] = (state, losses)
    (sg, lg), (sc, lc) = runs["cuda"], runs["cpu"]
    tg, tc = sg.params.table.cpu(), sc.params.table
    assert float(torch.linalg.norm(tg - tc) / torch.linalg.norm(tc)) < 1e-4
    np.testing.assert_allclose(sg.params.c_raw.cpu().numpy(),
                               sc.params.c_raw.numpy(), rtol=1e-4)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)


def test_graphed_resume_on_the_card(dev, tmp_path, capsys):
    """``product scan_chunk=4`` through the CLI on the card: 8 steps
    straight, and 4 then a resume to 8 (the generator registered with
    the graph restored by ``set_state``), within what two straight runs
    differ by."""
    import json

    from hyperspace_torch.cli import train as tcli
    from hyperspace_torch.train.checkpoint import restore_params_only

    base = ["product", "scan_chunk=4", "batch_size=256", "ckpt_every=4"]

    def run(tag, steps, *extra):
        assert tcli.main(base + [f"steps={steps}",
                                 f"ckpt_dir={tmp_path / tag}", *extra]) == 0
        json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        return restore_params_only(str(tmp_path / tag))[0]

    a, a2 = run("a", 8), run("a2", 8)
    run("b", 4)
    b = run("b", 8, "resume=true")
    ta, ta2, tb = (t["params"]["table"] for t in (a, a2, b))
    spread = float((ta - ta2).abs().max())
    assert float((ta - tb).abs().max()) <= spread
    assert torch.equal(a["generator"], b["generator"])
    assert int(a["step"]) == int(b["step"]) == 8


# --- the HTTP front door on the card ------------------------------------------


def _front_door_artifact(tmp_path, rows=4096):
    from hyperspace_torch.manifolds import PoincareBall
    from hyperspace_torch.serve import export_artifact

    gen = torch.Generator().manual_seed(50)
    table = PoincareBall(1.0).expmap0(
        0.5 * torch.randn(rows, 10, generator=gen)).numpy()
    path = str(tmp_path / "art")
    export_artifact(path, table, ("poincare", 1.0))
    return path


def _door_run(batcher, go, prewarm=(8,)):
    """Start a prewarmed ``HttpFrontDoor`` over ``batcher``, run
    ``go(door)`` (a coroutine function) against it, drain; its result."""
    import asyncio

    from hyperspace_torch.serve.server import HttpFrontDoor

    door = HttpFrontDoor(batcher, max_wait_us=2000)
    door.collator.prewarm(list(prewarm))

    async def main():
        await door.start()
        try:
            return await go(door)
        finally:
            await door.drain()

    return asyncio.run(main())


async def _post(door, path, payload):
    import asyncio
    import json

    reader, writer = await asyncio.open_connection(door.host, door.port)
    body = json.dumps(payload).encode()
    writer.write(f"POST {path} HTTP/1.1\r\nContent-Length: {len(body)}\r\n"
                 "Connection: close\r\n\r\n".encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, raw = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(raw)


@pytest.mark.parametrize("scan_mode", ["fused", "two_stage"])
def test_front_door_on_the_card_equals_the_stdin_loop(dev, tmp_path,
                                                      scan_mode):
    """/v1/topk and /v1/score over HTTP answer bit for bit what the
    stdin loop answers for the same requests (same buckets)."""
    import io
    import json

    from hyperspace_torch.cli import serve as tcli
    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)

    art = _front_door_artifact(tmp_path)
    reqs = [("/v1/topk", {"ids": [3, 99, 4000], "k": 8}),
            ("/v1/topk", {"ids": list(range(200, 264)), "k": 8}),
            ("/v1/score", {"u": [1, 2, 3], "v": [9, 8, 7], "prob": True})]
    lines = [{"op": p.rsplit("/", 1)[-1], **b} for p, b in reqs]
    out = io.StringIO()
    tcli.run_serve(tcli.ServeConfig(artifact=art, scan_mode=scan_mode),
                   stdin=io.StringIO("\n".join(json.dumps(x)
                                               for x in lines) + "\n"),
                   stdout=out)
    want = [json.loads(s) for s in out.getvalue().splitlines()]
    eng = QueryEngine.from_artifact(load_artifact(art), scan_mode=scan_mode)

    async def go(door):
        return [await _post(door, p, b) for p, b in reqs]

    got = _door_run(RequestBatcher(eng, cache_size=0), go)
    for (status, body), w in zip(got, want):
        assert status == 200 and body == w


def test_front_door_collates_on_the_card(dev, tmp_path):
    """64 concurrent single ids share fewer flushes than requests and
    answer what each id answers alone."""
    import asyncio

    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem

    eng = QueryEngine.from_artifact(load_artifact(
        _front_door_artifact(tmp_path)), scan_mode="fused")
    bat = RequestBatcher(eng, cache_size=0)
    reg = telem.default_registry()
    ids = list(range(1000, 1064))

    async def go(door):
        base = reg.mark()
        out = await asyncio.gather(*[_post(door, "/v1/topk",
                                           {"ids": [i], "k": 8})
                                     for i in ids])
        return out, reg.snapshot(baseline=base)["serve/collator_flushes"]

    got, flushes = _door_run(bat, go)
    assert flushes < len(ids)
    for i, (status, body) in zip(ids, got):
        ai, ad = bat.topk([i], 8)
        assert status == 200
        assert topk_disagreements(np.asarray(body["neighbors"]),
                                  np.asarray(body["dists"]), ai, ad,
                                  rtol=RTOL, atol=ATOL) == 0


def test_no_kernel_build_after_prewarm(dev, tmp_path):
    """Prewarm launches every bucket, k, exclude_self and ladder width
    on the dispatch thread; traffic after it builds and loads no kernel
    and meets no shape it did not launch."""
    import asyncio

    from hyperspace_torch.serve import (QueryEngine, RequestBatcher,
                                        load_artifact)
    from hyperspace_torch.telemetry import registry as telem

    reg = telem.default_registry()
    eng = QueryEngine.from_artifact(load_artifact(
        _front_door_artifact(tmp_path)), scan_mode="fused")
    bat = RequestBatcher(eng, cache_size=0, max_bucket=256, queue_max=64)

    async def go(door):
        base = reg.mark()
        sizes = (1, 7, 8, 33, 200, 256, 300)
        out = await asyncio.gather(*[_post(door, "/v1/topk", {
            "ids": list(range(n)), "k": 8, "exclude_self": bool(n % 2)})
            for n in sizes])
        d = reg.snapshot(baseline=base)
        return [s for s, _b in out], [d.get(c, 0) for c in (
            "kernels/builds", "kernels/loads", "serve/cold_dispatches")]

    statuses, new = _door_run(bat, go)
    assert statuses == [200] * 7 and new == [0, 0, 0]


# --- the bf16, int8 and int4 lanes ------------------------------------------


def lane_slabs(slab):
    """The slab in each narrow lane: (lane, rows, scale, packed)."""
    from hyperspace_torch.serve import quant as Q

    host = slab.cpu().numpy()
    q8, s8 = Q.quantize_rows(host)
    p4, s4 = Q.pack_int4_rows(host)
    dev = slab.device
    return [("bf16", slab.to(torch.bfloat16), None, False),
            ("int8", torch.as_tensor(q8, device=dev),
             torch.as_tensor(s8, device=dev), False),
            ("int4", torch.as_tensor(p4, device=dev),
             torch.as_tensor(s4, device=dev), True)]


@pytest.mark.parametrize("kind,d,n,m", [
    ("poincare", 10, 8, 2048), ("poincare", 10, 1024, 287),
    ("lorentz", 11, 37, 2051), ("poincare", 40, 37, 301)])
def test_pdist_bf16_kernel_within_one_ulp_of_plain(dev, kind, d, n, m):
    """bf16 in and out, f32 inside: within one bf16 ulp of the plain
    version beyond the f32 tier the two f32 results keep (RTOL, ATOL:
    hyperboloid rows lifted from radius 0.9 have x_0 up to 9.5, where the
    f32 Gram forms of near pairs differ by more than a bf16 ulp of d)."""
    rng = np.random.default_rng(12)
    x = rows(rng, n, d, kind, dev).to(torch.bfloat16)
    y = rows(rng, m, d, kind, dev).to(torch.bfloat16)
    before = pdist.launches_by_lane["bf16"]
    got = pdist(x, y, 1.0, manifold=kind)
    again = pdist(x, y, 1.0, manifold=kind)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert pdist.launches_by_lane["bf16"] == before + 2
    want = pdist_plain(x, y, 1.0, manifold=kind).float()
    ulp = torch.where(want > 0, 2.0 ** (torch.floor(torch.log2(want)) - 7),
                      torch.full_like(want, 2.0 ** -133))
    assert bool(((got.float() - want).abs()
                 <= ulp + ATOL + RTOL * want.abs()).all())


@pytest.mark.parametrize("kind,d", [("poincare", 10), ("lorentz", 11),
                                    ("euclidean", 3), ("poincare", 40)])
@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("b", [8, 300])
def test_scan_topk_lanes_match_plain(dev, kind, d, k, b):
    """Each narrow lane against the plain version on the same widened
    rows, with col0 and n cut and exclude_self; twice, bitwise."""
    rng = np.random.default_rng(13)
    m = 3001
    slab, q = rows(rng, m, d, kind, dev), rows(rng, b, d, kind, dev)
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    for lane, lrows, scale, packed in lane_slabs(slab):
        for ex, col0, n in ((False, 0, m), (True, 400, 400 + m - 77)):
            qi = torch.as_tensor(rng.integers(col0, col0 + m, b),
                                 dtype=torch.int32, device=dev)
            before = scan_topk.launches_by_lane[lane]
            run = lambda: scan_topk(lrows, q, qi, col0, spec=spec, k=k,  # noqa: E731
                                    n=n, exclude_self=ex, scale=scale,
                                    packed=packed)
            got, again = run(), run()
            torch.cuda.synchronize()
            assert scan_topk.launches_by_lane[lane] == before + 2
            assert torch.equal(got[0], again[0])
            assert torch.equal(got[1], again[1])
            wd, wi = scan_topk_plain(lrows, q, qi, col0, kind=kind,
                                     c=spec[1], k=k, n=n, exclude_self=ex,
                                     scale=scale, packed=packed)
            assert topk_disagreements(
                got[1].cpu().numpy(), got[0].cpu().numpy(),
                wi.cpu().numpy(), wd.cpu().numpy(), rtol=RTOL,
                atol=ATOL) == 0, lane


@pytest.mark.parametrize("kind,d", [("poincare", 10), ("lorentz", 11),
                                    ("euclidean", 7)])
@pytest.mark.parametrize("k", [10, 256])
def test_scan_topk_cand_lanes_match_plain(dev, kind, d, k):
    """bf16 and int8 candidate lanes, pads in mid-list, exclude_self."""
    rng = np.random.default_rng(14)
    table = rows(rng, 20000, d, kind, dev)
    q = rows(rng, 300, d, kind, dev)
    cand = torch.as_tensor(rng.integers(0, 20000, (300, 1500)),
                           dtype=torch.int32, device=dev)
    cand[:, 100:133] = -1
    qi = cand[:, 17].clone()
    spec = (kind, 0.0 if kind == "euclidean" else 1.0)
    for lane, ltab, scale, _ in lane_slabs(table)[:2]:
        before = scan_topk_cand.launches_by_lane[lane]
        run = lambda: scan_topk_cand(ltab, cand, q, qi, spec=spec, k=k,  # noqa: E731
                                     exclude_self=True,
                                     scale=None if scale is None
                                     else scale.reshape(-1))
        got, again = run(), run()
        torch.cuda.synchronize()
        assert scan_topk_cand.launches_by_lane[lane] == before + 2
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        want = scan_topk_cand_plain(ltab, cand, q, qi, kind=kind, c=spec[1],
                                    k=k, exclude_self=True, scale=scale)
        assert_cand_close(kind, table, got, want)


def test_lane_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(15)
    slab = rows(rng, 500, 10, "poincare", dev)
    q = rows(rng, 4, 10, "poincare", dev)
    qi = torch.zeros(4, dtype=torch.int32, device=dev)
    spec = ("poincare", 1.0)
    (_, b16, _, _), (_, q8, s8, _), (_, p4, s4, _) = lane_slabs(slab)
    with pytest.raises(ValueError, match="float32"):   # int8 scale as f16
        scan_topk(q8, q, qi, 0, spec=spec, k=5, n=500, scale=s4)
    with pytest.raises(ValueError, match="float16"):   # int4 scale as f32
        scan_topk(p4, q, qi, 0, spec=spec, k=5, n=500, scale=s8,
                  packed=True)
    with pytest.raises(ValueError, match="entries"):
        scan_topk(q8, q, qi, 0, spec=spec, k=5, n=500, scale=s8[:-1])
    with pytest.raises(ValueError, match="one dtype"):
        pdist(q, b16, 1.0, manifold="poincare")
    cand = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="want table"):  # no int4 lane
        scan_topk_cand(p4, cand, q, qi, spec=spec, k=5)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("nprobe", [0, 2])
def test_engine_lanes_agree_on_cuda(dev, precision, nprobe):
    """Each lane's engine on the card, fused and two-stage, against the
    CPU engine on the same table and index: ids equal outside near-ties;
    fused launches the lane's kernel once a batch."""
    from hyperspace_torch.serve.index import build_index

    rng = np.random.default_rng(16)
    table = rows(rng, 6000, 10, "poincare", dev).cpu().numpy()
    spec = ("poincare", 1.0)
    index = build_index(table, spec, 40)
    q = np.arange(0, 6000, 41)
    out = {}
    for mode in ("two_stage", "fused"):
        eng = QueryEngine(table, spec, scan_mode=mode, precision=precision,
                          index=index, nprobe=nprobe)
        before = (scan_topk.launches_by_lane[precision],
                  scan_topk_cand.launches_by_lane.get(precision, 0))
        i, d = eng.topk_neighbors(q, 10)
        after = (scan_topk.launches_by_lane[precision],
                 scan_topk_cand.launches_by_lane.get(precision, 0))
        fused_cand = nprobe and precision != "int4"
        want = ((0, 0) if mode == "two_stage"
                else (0, 1) if fused_cand else (0, 0) if nprobe
                else (1, 0))
        assert tuple(a - b for a, b in zip(after, before)) == want
        out[mode] = (i.cpu().numpy(), d.cpu().numpy())
    cpu = QueryEngine(table, spec, device="cpu", precision=precision,
                      index=index, nprobe=nprobe)
    ci, cd = (a.numpy() for a in cpu.topk_neighbors(q, 10))
    for i, d in out.values():
        assert topk_disagreements(i, d, ci, cd, rtol=RTOL, atol=ATOL) == 0


# --- graphed HyboNet and HGCN steps, the guard and the spine on the card ----


def _live_bitwise(a, b) -> bool:
    from hyperspace_torch.train.checkpoint import _to_host, to_tree

    la = torch.utils._pytree.tree_leaves(_to_host(to_tree(a)))
    lb = torch.utils._pytree.tree_leaves(_to_host(to_tree(b)))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _graphed_against_eager(fresh, step, k, counters, per_step=()):
    """A live chunk of ``k`` replays against ``k`` eager steps from the
    same start, twice (capture, then replays alone); the second chunk's
    launches, ``k`` × ``per_step`` of each counter given."""
    from hyperspace_torch.train.loop import ChunkedStepper

    eager, graphed = fresh(), fresh()
    chunk = ChunkedStepper(step, k, live=True, counters=counters)
    for part in range(2):
        want = torch.stack([step(eager)[1] for _ in range(k)])
        for c in counters:
            c.launches = 0
        _, got = chunk(graphed)
        torch.cuda.synchronize()
        assert torch.equal(want, got), part
        assert _live_bitwise(eager, graphed), part
    for c, per in zip(counters, per_step):
        assert c.launches == k * per


@pytest.mark.parametrize("accum", [1, 2])
def test_graphed_hybonet_chunk_is_its_eager_steps(dev, accum):
    from hyperspace_torch.cli.train import ModuleState
    from hyperspace_torch.data.text import synthetic_text
    from hyperspace_torch.models import hybonet
    from hyperspace_torch.optim.accum import with_grad_accumulation

    ds = synthetic_text(num_samples=128, vocab_size=64, num_classes=4,
                        max_len=16, seed=0)
    cfg = hybonet.HyboNetConfig(vocab_size=64, num_classes=4, max_len=16,
                                dim=32, num_heads=2, num_layers=2,
                                batch_size=16)
    data = [torch.as_tensor(a, device=dev)
            for a in (ds.tokens, ds.mask, ds.labels)]

    def fresh():
        model, opt, st = hybonet.init_model(cfg, 0, dev)
        return ModuleState(model, with_grad_accumulation(opt, None,
                                                         accum)[0], st)

    def step(s):
        return s, hybonet.train_step_sampled(s.model, s.opt, s.train,
                                             *data)[1]

    _graphed_against_eager(fresh, step, 4, hybonet.path_counters(),
                           [2, 2, 2, 1])


@pytest.mark.parametrize("task", ["lp", "nc", "att"])
def test_graphed_hgcn_chunk_is_its_eager_steps(dev, task):
    from hyperspace_torch.cli.train import ModuleState
    from hyperspace_torch.data import graphs as G
    from hyperspace_torch.models import hgcn

    e, x, lab, k = G.community_power_law_graph(
        num_nodes=600, num_edges=2400, num_classes=5, feat_dim=16, seed=1)
    cfg = hgcn.HGCNConfig(feat_dim=16, hidden_dims=(16, 8),
                          agg_dtype=torch.bfloat16, use_att=task == "att",
                          num_classes=k if task == "nc" else 0)
    cmp_ = G.cluster_min_pair_for(cfg.use_att)
    if task == "nc":
        tr, va, te = G.node_split_masks(600, seed=0)
        g = G.prepare(e, 600, x, labels=lab, num_classes=k, train_mask=tr,
                      val_mask=va, test_mask=te, cluster_min_pair=cmp_,
                      cache=False)
        ga = G.to_device(g, dev)
        y, mask = hgcn.nc_targets(g, dev)

        def fresh():
            return ModuleState(*hgcn.init_nc(cfg, g, seed=0, device=dev))

        def step(st):
            return st, hgcn.train_step_nc(st.model, st.opt, st.train, ga, y,
                                          mask)[1]
    else:
        split = G.split_edges(e, 600, x, seed=0, cluster_min_pair=cmp_,
                              cache=False)
        ga = G.to_device(split.graph, dev)
        pos = G.index_tensor(split.train_pos, dev)

        def fresh():
            return ModuleState(*hgcn.init_lp(cfg, split.graph, seed=0,
                                             device=dev))

        def step(st):
            return st, hgcn.train_step_lp(st.model, st.opt, 600, st.train,
                                          ga, pos)[1]

    _graphed_against_eager(fresh, step, 4, hgcn.path_counters())


def test_graphed_rollback_and_spine_on_the_card(dev, tmp_path):
    """A NaN in a graphed HyboNet run rolls back to the last commit and
    ends at the unfaulted run's state; ``profile_steps`` observes the
    profiled chunks' device step."""
    import io
    import json
    from contextlib import redirect_stdout

    from hyperspace_torch.cli import train as tcli
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.train.checkpoint import restore_params_only

    base = ["hybonet", "dim=32", "num_heads=2", "num_layers=2",
            "batch_size=16", "steps=16", "scan_chunk=4", "ckpt_every=4",
            "eval_every=4"]

    def run(tag, *extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            tcli.main(base + [f"ckpt_dir={tmp_path / tag}",
                              f"log={tmp_path / tag}.jsonl", *extra])
        return json.loads(buf.getvalue().splitlines()[-1])

    clean = run("clean")
    mark = telem.default_registry().mark()
    res = run("nan", "rollback=1", "chaos=train.step_nan:nan:after=2",
              "telemetry=1", "profile_steps=8")
    delta = telem.default_registry().snapshot(baseline=mark)
    with open(tmp_path / "nan.jsonl") as f:
        recs = [json.loads(line) for line in f]
    ev = [r for r in recs if r.get("event") == "rollback"]
    assert len(ev) == 1 and ev[0]["restored_step"] == 8
    assert recs[0]["event"] == "run_manifest"
    assert recs[0]["backend"] == "cuda"
    assert delta["hist/train/phase/device_step_ms"]["count"] == 2
    assert res["loss"] == clean["loss"]
    a, _ = restore_params_only(str(tmp_path / "clean"))
    b, _ = restore_params_only(str(tmp_path / "nan"))
    la, lb = (torch.utils._pytree.tree_leaves(t) for t in (a, b))
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(la, lb))


@pytest.mark.parametrize("form", ["step", "step_on_device"])
@pytest.mark.parametrize("max_norm", [None, 1.0])
def test_adamw_device_count_is_the_python_count_on_the_card(dev, max_norm,
                                                           form):
    """On the card PyTorch divides by a Python float through its float64
    reciprocal: the device-count update keeps those bits, and so does
    ``GradAccumulation``'s running mean (k = 3: a third is inexact), in
    its eager form and in the form a graph captures."""
    from hyperspace_torch.optim.accum import GradAccumulation
    from hyperspace_torch.optim.adamw import AdamW
    from tests.test_torch_graphed_steps import (PythonCountAdamW,
                                                PythonGradAccumulation)

    g = torch.Generator().manual_seed(0)
    p0 = {"w": torch.randn(300, 37, generator=g),
          "b": torch.randn(11, generator=g) * 1e-3}
    new = GradAccumulation(AdamW({k: v.to(dev) for k, v in p0.items()},
                                 1e-2, 1e-2, max_norm), 3)
    old = PythonGradAccumulation(PythonCountAdamW(
        {k: v.to(dev) for k, v in p0.items()}, 1e-2, 1e-2, max_norm), 3)
    gen = torch.Generator().manual_seed(1)
    for _ in range(30):
        grads = [(torch.randn(p.shape, generator=gen) * 0.1).to(dev)
                 for p in new.params]
        getattr(new, form)([t.clone() for t in grads])
        old.step(grads)
    for a, b in zip(new.params + new.acc + new.inner.mu,
                    old.inner.params + old.acc + old.inner.mu):
        assert torch.equal(a, b)
    assert int(new.inner.count) == old.inner.count == 10


# --- the live index and engine paging (serve/delta.py, serve/registry.py) ----


def _live_table(n, seed):
    from hyperspace_torch.manifolds import PoincareBall

    g = torch.Generator().manual_seed(seed)
    return PoincareBall(1.0).expmap0(
        torch.randn(n, 10, generator=g, dtype=torch.float64) * 0.5
    ).float().numpy()


@pytest.mark.parametrize("nprobe", [0, 8])
def test_masked_two_stage_and_delta_scans_match_cpu(dev, nprobe):
    """``topk_neighbors(q_rows=, drop=)`` (the masked two-stage path:
    ``pdist`` chunks plus the penalty row) and the delta scan on the card
    against the same calls on the CPU; fresh query rows, 1 in 7 rows
    tombstoned.  Ids equal outside near-ties, distances rtol 1e-5,
    atol 1e-4."""
    from hyperspace_torch.serve.delta import _delta_scan
    from hyperspace_torch.serve.index import build_index

    table = _live_table(20000, 1)
    spec = ("poincare", 1.0)
    index = build_index(table, spec, 64, iters=3, device="cpu") \
        if nprobe else None
    engs = [QueryEngine(table, spec, index=index, nprobe=nprobe, device=d,
                        scan_mode="fused") for d in (dev, "cpu")]
    rng = np.random.default_rng(2)
    drop = np.zeros(engs[0].table.shape[0], np.float32)
    drop[rng.choice(20000, 20000 // 7, replace=False)] = np.inf
    q_idx = rng.integers(0, 20000, 64)
    q_rows = _live_table(64, 3)
    outs = [e.topk_neighbors(q_idx, 10, q_rows=q_rows, drop=drop,
                             allow_underfill=True) for e in engs]
    (ci, cd), (pi, pd) = [(i.cpu().numpy(), d.cpu().numpy())
                          for i, d in outs]
    assert np.all(np.isfinite(pd)) and not np.any(drop[pi] > 0)
    assert topk_disagreements(ci, cd, pi, pd, rtol=RTOL, atol=ATOL) == 0
    rows, pen = _live_table(1024, 4), np.zeros(1024, np.float32)
    pen[700:] = np.inf
    ids = np.arange(20000, 21024, dtype=np.int32)
    got = _delta_scan(*(torch.as_tensor(x, device=dev) for x in (
        q_rows, rows, pen, q_idx.astype(np.int32), ids)), spec=spec,
        exclude_self=True).cpu()
    want = _delta_scan(*(torch.as_tensor(x) for x in (
        q_rows, rows, pen, q_idx.astype(np.int32), ids)), spec=spec,
        exclude_self=True)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_live_upserts_interleaved_with_queries_answer_their_generation(dev):
    """One thread upserts (updates and inserts, one batch a generation)
    while another queries; each answer equals, bitwise, the answer of a
    sequential replay at a generation between the query's first and last
    reading of ``generation``: the device mirrors a scan holds never
    change under it."""
    import threading

    from hyperspace_torch.parallel.host_table import HostEmbedTable
    from hyperspace_torch.serve.delta import LiveQueryEngine

    table = _live_table(30000, 5)
    spec = ("poincare", 1.0)
    rng = np.random.default_rng(6)
    batches = []
    for g in range(40):
        ids = [int(rng.integers(0, 30000)), 30000 + g]
        batches.append((ids, _live_table(2, 100 + g)))
    q = np.asarray([0, 11, 222, 3333, 29999, 7, 8], np.int64)

    def fresh():
        return LiveQueryEngine(QueryEngine(table, spec, device=dev),
                               HostEmbedTable.from_array(table.copy()),
                               capacity=128, auto_compact=False)

    def ask(eng):
        i, d = eng.topk_neighbors(q, 10)
        return i.cpu().numpy(), d.cpu().numpy()

    eng = fresh()
    ref = {0: ask(eng)}
    for g, (ids, rows) in enumerate(batches, 1):
        eng.upsert(ids, rows)
        ref[g] = ask(eng)
    live, seen, done = fresh(), [], threading.Event()

    def writer():
        for ids, rows in batches:
            live.upsert(ids, rows)
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    while not done.is_set() or len(seen) < 5:
        g0 = live.generation
        ans = ask(live)
        seen.append((g0, live.generation, ans))
    t.join(60)
    assert not t.is_alive()
    for g0, g1, (i, d) in seen:
        assert any(np.array_equal(ref[g][0], i)
                   and np.array_equal(ref[g][1], d)
                   for g in range(g0, g1 + 1)), (g0, g1)


def test_eviction_frees_at_least_the_engines_device_bytes(dev, tmp_path):
    """Paging a tenant out lowers ``memory_allocated`` by at least its
    ``engine_device_bytes`` (its tensors go back to the caching
    allocator), and re-admitting it answers bitwise as before."""
    import asyncio
    import gc

    from hyperspace_torch.serve.artifact import export_artifact
    from hyperspace_torch.serve.index import build_index
    from hyperspace_torch.serve.registry import EngineRegistry

    table = _live_table(50000, 7)
    spec = ("poincare", 1.0)
    export_artifact(str(tmp_path / "a"), table, spec,
                    index=build_index(table, spec, 64, iters=2,
                                      device="cpu"))
    export_artifact(str(tmp_path / "b"), table[:40000].copy(), spec)
    reg = EngineRegistry()
    try:
        for name, kw in (("a", {"nprobe": 8, "precision": "bf16"}),
                         ("b", {})):
            reg.add_tenant(name, str(tmp_path / name), window_s=0.0,
                           engine_kw={"device": dev, **kw})
        ids = [1, 2, 3, 99]
        for name in ("a", "b"):
            stack = reg.resolve(name)
            before_ans = stack.batcher.topk(ids, 10)
            torch.cuda.synchronize()
            gc.collect()
            before = torch.cuda.memory_allocated()
            reg._evict(stack)
            gc.collect()
            freed = before - torch.cuda.memory_allocated()
            assert stack.device_bytes > 0 and freed >= stack.device_bytes
            asyncio.run(reg.ensure_resident(stack))
            stack.batcher.cache = type(stack.batcher.cache)(0)
            again = stack.batcher.topk(ids, 10)
            assert all(np.array_equal(x, y)
                       for x, y in zip(before_ans, again))
    finally:
        reg.close()


# --- the host-resident trainer (train/host_embed.py) -----------------------


def _host_setup(dev, optimizer, batch=128):
    from hyperspace_torch.data.wordnet import synthetic_tree
    from hyperspace_torch.models import poincare_embed as pe

    ds = synthetic_tree(4, 6)                       # 1,555 nodes
    cfg = pe.PoincareEmbedConfig(num_nodes=ds.num_nodes, dim=8,
                                 batch_size=batch, neg_samples=10,
                                 optimizer=optimizer, burnin_steps=5)
    st, opt = pe.init_state(cfg, 3, dev)
    return ds, cfg, st, opt


@pytest.mark.parametrize("optimizer", ["rsgd", "radam"])
@pytest.mark.parametrize("evict", [False, True])
def test_host_trainer_is_bitwise_the_inhbm_reference(dev, optimizer, evict):
    """Graphed chunks over the hot-row cache (with evictions: chunks of 1
    over a cache of one step's worst case) against the in-HBM packed
    chunks on the same plans: master, moments and losses bitwise."""
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.train import host_embed as he

    ds, cfg, st, opt = _host_setup(dev, optimizer)
    chunk = 1 if evict else 4
    hot = he.auto_hot_rows(cfg, 1) if evict else 0
    tr = he.HostPlannedTrainer.from_state(cfg, opt, _pe_clone(st),
                                          chunk_steps=chunk, hot_rows=hot,
                                          seed=5)
    if evict:
        assert tr.cache.capacity < cfg.num_nodes
    losses = tr.run(ds.pairs, 14)
    ref, ref_losses = he.run_planned_inhbm(cfg, opt, _pe_clone(st),
                                           ds.pairs, 14, chunk_steps=chunk,
                                           seed=5)
    assert np.array_equal(losses, ref_losses)
    assert np.array_equal(tr.master.to_array(),
                          pe.pack_state(cfg, ref).packed.cpu().numpy())


def test_host_trainer_captures_once_and_keeps_its_cache(dev):
    """Six chunks of one length: one capture, the cache tensor the graph
    returned stays the cache (``ensure`` writes into it), and no kernel
    library is built or loaded after the first chunk."""
    from hyperspace_torch.models import poincare_embed as pe
    from hyperspace_torch.telemetry import registry as telem
    from hyperspace_torch.train import host_embed as he

    ds, cfg, st, opt = _host_setup(dev, "radam", batch=32)
    reg = telem.default_registry()
    caps = pe.graph_captures()
    tr = he.HostPlannedTrainer.from_state(cfg, opt, st, chunk_steps=4,
                                          seed=1)
    assert tr.cache.capacity < cfg.num_nodes       # uploads every chunk
    tr.run(ds.pairs, 4)
    ptr = tr.cache.array.data_ptr()
    builds = (reg.get("kernels/builds"), reg.get("kernels/loads"))
    mark = reg.mark()
    losses = tr.run(ds.pairs, 20)
    assert np.all(np.isfinite(losses))
    assert pe.graph_captures() - caps == 1
    assert tr.cache.array.data_ptr() == ptr
    assert (reg.get("kernels/builds"), reg.get("kernels/loads")) == builds
    delta = reg.snapshot(baseline=mark)
    assert delta["host_table/chunks"] == 5
    assert delta.get("host_table/upload_rows", 0) > 0
