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

from hyperspace_torch.benchmarks import hgcn_bench, workloads_bench
from hyperspace_torch.cli import train as cli_train
from hyperspace_torch.kernels import _support
from hyperspace_torch.kernels import attention as flash
from hyperspace_torch.kernels.cluster import (cluster_aggregate,
                                              cluster_att_bwd,
                                              cluster_att_fwd)
from hyperspace_torch.kernels import pointwise as rowwise
from hyperspace_torch.kernels.distmat import pdist
from hyperspace_torch.kernels.hyplinear import hyp_linear
from hyperspace_torch.kernels.mlr import hyp_mlr
from hyperspace_torch.kernels.scan_topk import scan_topk
from hyperspace_torch.kernels.segment import (csr_att_bwd_edges,
                                              csr_segment_reduce_1d,
                                              csr_segment_sum)
from hyperspace_torch.models import hgcn, hybonet
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
                 "hyperspace_torch.benchmarks.hgcn_bench",
                 "hyperspace_torch.data.text", "hyperspace_torch.nn.attention",
                 "hyperspace_torch.nn.layers", "hyperspace_torch.nn.mlr",
                 "hyperspace_torch.kernels.attention",
                 "hyperspace_torch.kernels.mlr",
                 "hyperspace_torch.models.hybonet",
                 "hyperspace_torch.optim.adamw", "hyperspace_torch.cli.train",
                 "hyperspace_torch.benchmarks.workloads_bench",
                 "hyperspace_torch.serve.index",
                 "hyperspace_torch.serve.quant",
                 "hyperspace_torch.manifolds.base",
                 "hyperspace_torch.kernels.pointwise",
                 "hyperspace_torch.kernels.hyplinear"):
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgcn_bench.run_hgcn_bench(steps=1, num_nodes=64, use_att=True)


def test_hybonet_entry_points_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg = hybonet.HyboNetConfig(dim=8, num_heads=2, num_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hybonet.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["hybonet", "steps=1", "dim=8", "num_heads=2",
                        "num_layers=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workloads_bench.setup_leg("hybonet_long")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workloads_bench.run_workloads_bench(steps=1, repeats=1)


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
    v = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        csr_segment_reduce_1d(v, ids, None, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        csr_att_bwd_edges(torch.zeros((4, 4), device="meta"), x, v, v, ids,
                          None, 4, 30.0, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_att_fwd(x, v, v, ids, ids, None, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_att_bwd(torch.zeros((4, 4), device="meta"), x, v, v, ids,
                        ids, None, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        hyp_mlr(x, x, x, 1.0)
    q, b = torch.zeros((2, 5, 4), device="meta"), torch.ones(2, device="meta")
    for fn in (flash.flash_fwd, flash.flash_dq, flash.flash_dkv):
        extra = () if fn is flash.flash_fwd else (q, b[:, None].expand(2, 5),
                                                  b[:, None].expand(2, 5))
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, 1.0, b, b, None, 1, *extra)
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_attention(q, q, q, 1.0)
    for op, args in (("mobius_add", (x, x)), ("mobius_scalar_mul", (0.5, x)),
                     ("expmap", (x, x)), ("logmap", (x, x)),
                     ("expmap0", (x,)), ("logmap0", (x,)),
                     ("ptransp", (x, x, x))):
        with pytest.raises(ValueError, match="unsupported device"):
            getattr(rowwise, op)(*args, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        hyp_linear(x, torch.zeros((3, 2), device="meta"),
                   torch.zeros(2, device="meta"), 1.0)


def test_hybonet_wrappers_check_shapes():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="want x"):
        hyp_mlr(x, torch.zeros((2, 4)), torch.zeros((2, 4)), 1.0)
    with pytest.raises(ValueError, match="want x"):
        hyp_mlr(x, torch.zeros((2, 3)), torch.zeros((3, 3)), 1.0)
    q, b = torch.zeros((2, 5, 4)), torch.ones(2)
    with pytest.raises(ValueError, match="want q"):
        flash.flash_fwd(q, q[:, :, :3], q[:, :, :3], 1.0, b, b)
    with pytest.raises(ValueError, match="beta and tau"):
        flash.flash_fwd(q, q, q, 1.0, b[:1], b)
    m = torch.ones((2, 5, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="want a mask"):
        flash.flash_fwd(q, q, q, 1.0, b, b, m, 2)
    out, lse, nrm = flash.flash_fwd(q, q, q, 1.0, b, b, m[:1], 2)
    assert out.shape == q.shape and lse.shape == nrm.shape == (2, 5)


def test_kernels_line_names_every_cuda_entry():
    """Every exported launcher of every csrc/*.cu appears in
    chip_smoke.py's kernels line with its source, so no kernel can be
    built and never checked."""
    import re

    csrc = os.path.join(REPO, "hyperspace_torch", "kernels", "csrc")
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    found = 0
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        assert f'"hyperspace_torch/kernels/csrc/{name}"' in smoke, name
        with open(os.path.join(csrc, name)) as f:
            entries = re.findall(r'extern "C" int (\w+)\(', f.read())
        assert entries, name
        for entry in entries:
            found += 1
            assert f'"{entry}"' in smoke, entry
    assert found >= 22


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
