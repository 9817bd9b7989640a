"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This module
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: float32 distances rtol 1e-5, atol 1e-4 (the kernel and the
plain version sum in different orders); ids equal outside runs of
near-ties.  Queries are never table rows here: at d = 0 the Gram form's
rounding noise differs between the two.  The scatter kernels: float32
rtol = atol = 1e-5 (sums in another order); bf16 within one bf16 ulp of
the plain version's result (both sum in f32 and round once).
"""

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels._support import topk_disagreements
from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                              cluster_aggregate_plain)
from hyperspace_torch.kernels.distmat import pdist, pdist_plain
from hyperspace_torch.kernels.segment import (csr_segment_sum,
                                              csr_segment_sum_plain)
from hyperspace_torch.kernels.scan_topk import scan_topk, scan_topk_plain
from hyperspace_torch.manifolds.maps import ball_to_lorentz
from hyperspace_torch.serve.engine import QueryEngine

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rows(rng, n, d, kind, dev):
    if kind == "euclidean":
        return torch.as_tensor(rng.standard_normal((n, d)),
                               dtype=torch.float32, device=dev)
    dd = d - 1 if kind == "lorentz" else d
    v = rng.standard_normal((n, dd))
    v *= rng.uniform(0.0, 0.9, (n, 1)) / np.linalg.norm(v, axis=1,
                                                        keepdims=True)
    x = torch.as_tensor(v, dtype=torch.float32, device=dev)
    return ball_to_lorentz(x, 1.0).contiguous() if kind == "lorentz" else x


@pytest.mark.parametrize("kind,d", [("poincare", 3), ("poincare", 10),
                                    ("poincare", 40), ("lorentz", 11)])
def test_pdist_kernel_matches_plain(dev, kind, d):
    rng = np.random.default_rng(0)
    x, y = rows(rng, 37, d, kind, dev), rows(rng, 301, d, kind, dev)
    before = pdist.launches
    got = pdist(x, y, 1.0, manifold=kind)
    torch.cuda.synchronize()
    assert pdist.launches == before + 1
    want = pdist_plain(x, y, 1.0, manifold=kind)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f", [(300, 2000, 17), (50, 64, 128),
                                   (7, 3, 5), (1000, 5000, 130),
                                   (500, 4000, 1), (64, 0, 8),
                                   (2000, 20000, 300)])
def test_csr_segment_sum_kernel_matches_plain(dev, dt, n, e, f):
    rng = np.random.default_rng(n + e + f)
    # a hub row, empty rows and a zero-valued padding tail at row n - 1
    r = np.sort(np.where(rng.random(e) < 0.3, n // 3,
                         rng.integers(0, max(n // 2, 1), e)))
    r = np.concatenate([r, np.full(37, n - 1)]).astype(np.int32)
    v = torch.as_tensor(rng.standard_normal((len(r), f)), dtype=dt,
                        device=dev)
    v[e:] = 0
    rr = torch.as_tensor(r, device=dev)
    before = csr_segment_sum.launches
    got = csr_segment_sum(v, rr, None, n)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 1
    want = csr_segment_sum_plain(v, rr, n)
    assert_scatter_close(got, want, order_bound(
        rr, csr_segment_sum_plain(v.float().abs(), rr, n), n))
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
