"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This module
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: float32 distances rtol 1e-5, atol 1e-4 (the kernel and the
plain version sum in different orders); ids equal outside runs of
near-ties.  Queries are never table rows here: at d = 0 the Gram form's
rounding noise differs between the two.
"""

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels._support import topk_disagreements
from hyperspace_torch.kernels.distmat import pdist, pdist_plain
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
