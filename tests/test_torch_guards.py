"""Guards on the port's boundaries: it imports neither JAX nor the JAX
package, its entry points want CUDA unless the caller asks for the CPU,
and a wrapper never runs its plain version on a device other than the
CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hyperspace_torch.benchmarks import hgcn_bench
from hyperspace_torch.kernels import _support
from hyperspace_torch.kernels.cluster import cluster_aggregate
from hyperspace_torch.kernels.distmat import pdist
from hyperspace_torch.kernels.scan_topk import scan_topk
from hyperspace_torch.kernels.segment import csr_segment_sum
from hyperspace_torch.models import hgcn
from hyperspace_torch.serve.engine import QueryEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import hyperspace_torch
names = [m.name for m in pkgutil.walk_packages(hyperspace_torch.__path__,
                                               "hyperspace_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib") or n.startswith(
                 ("jax.", "jaxlib.", "hyperspace_tpu")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for name in ("hyperspace_torch.cli.serve", "hyperspace_torch.serve.engine",
                 "hyperspace_torch.kernels.scan_topk",
                 "hyperspace_torch.manifolds.smath",
                 "hyperspace_torch.data.graphs",
                 "hyperspace_torch.kernels.segment",
                 "hyperspace_torch.kernels.cluster",
                 "hyperspace_torch.nn.scatter", "hyperspace_torch.nn.edge_dist",
                 "hyperspace_torch.nn.gcn", "hyperspace_torch.nn.decoders",
                 "hyperspace_torch.precision", "hyperspace_torch.utils.metrics",
                 "hyperspace_torch.models.hgcn",
                 "hyperspace_torch.benchmarks.hgcn_bench"):
        assert name in res["modules"]


def test_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    table = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine(table, ("poincare", 1.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _support.resolve_device("cuda")
    assert _support.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        _support.resolve_device("meta")


def test_training_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = hgcn.HGCNConfig(feat_dim=4, hidden_dims=(4, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgcn.init_lp(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgcn_bench.run_hgcn_bench(steps=1, num_nodes=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgcn_bench.setup_lp(64)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pdist(x, x, 1.0, manifold="poincare")
    with pytest.raises(ValueError, match="unsupported device"):
        scan_topk(x, x, torch.zeros(4, dtype=torch.int32, device="meta"), 0,
                  spec=("poincare", 1.0), k=2, n=4)
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        csr_segment_sum(torch.zeros((4, 3), device="meta"), ids, None, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_aggregate(x, torch.zeros(4, device="meta"), ids, ids, None, 4)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No compiler means no kernel: the build raises, nothing falls back."""
    monkeypatch.setattr(_support.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_support, "BUILD_DIR", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _support.build_all(["pdist"])


def test_launchers_check_inputs():
    f32 = (torch.float32,)
    with pytest.raises(ValueError, match="float32"):
        _support.check_cuda("k", f32, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        _support.check_cuda("k", f32, torch.zeros((3, 2)).T)
    with pytest.raises(ValueError, match="bfloat16, float32"):
        _support.check_cuda("k", (torch.bfloat16, torch.float32),
                            torch.zeros(2, dtype=torch.float64))
    _support.check_cuda("k", (torch.bfloat16, torch.float32),
                        torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2))
    _support.check(0, "k")
    with pytest.raises(RuntimeError, match="error 98"):
        _support.check(98, "k")
