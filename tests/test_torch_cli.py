"""The port's serving CLI against the JAX CLI on the same artifact and the
same request lines: neighbours equal (id sets inside runs of near-ties),
distances rtol 1e-5 / atol 1e-4 (the sides sum the Gram products in
different orders), scores atol 1e-6, error lines of the same kind."""

import io
import json

import numpy as np
import pytest

from hyperspace_tpu.cli import serve as jcli
from hyperspace_tpu.serve.artifact import export_artifact
from hyperspace_torch.cli import serve as tcli
from hyperspace_torch.kernels._support import topk_disagreements
from hyperspace_torch.telemetry import registry as tregistry
from tests.test_torch_serve import C, make_table

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for man in ("poincare", "lorentz"):
        out[man] = str(root / man)
        export_artifact(out[man], make_table(man, n=700, seed=4), (man, C))
    return out


def _same_topk(a: dict, b: dict) -> None:
    ia, da = np.asarray(a["neighbors"]), np.asarray(a["dists"])
    ib, db = np.asarray(b["neighbors"]), np.asarray(b["dists"])
    assert ia.shape == ib.shape
    assert topk_disagreements(ia, da, ib, db, rtol=RTOL, atol=ATOL) == 0


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
def test_query_mode_matches_jax(capsys, artifacts, manifold, scan_mode):
    art = artifacts[manifold]
    flags = [f"artifact={art}", f"scan_mode={scan_mode}", "chunk_rows=256"]
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["device=cpu"])):
        assert main(["query", *flags, *extra, "ids=0,5,699,5", "k=6"]) == 0
        topk = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert main(["query", *flags, *extra, "u=0,1,2", "v=3,4,2",
                     "prob=1"]) == 0
        score = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs.append((topk, score))
    (jt, js), (tt, ts) = outs
    assert set(tt) == set(jt) and tt["ids"] == jt["ids"] and tt["k"] == 6
    _same_topk(tt, jt)
    assert set(ts) == set(js) == {"mode", "scores"}
    np.testing.assert_allclose(ts["scores"], js["scores"], atol=1e-6)


LINES = [
    {"op": "topk", "ids": [0, 1, 2], "k": 5},
    {"op": "topk", "ids": list(range(40)), "k": 9, "request_id": "r-1"},
    {"op": "score", "u": [0, 1, 7], "v": [2, 3, 9], "prob": True},
    {"op": "score", "u": [0, 1], "v": [2, 3], "fd_r": 1.0, "fd_t": 2.0,
     "prob": True},
    "not json at all",
    [1, 2],
    {"op": "bogus"},
    {"op": "topk", "ids": [0.5], "k": 3},
    {"op": "topk", "ids": [0], "k": 1.5},
    {"op": "topk", "ids": [70000], "k": 3, "request_id": "r-2"},
    {"op": "topk"},
    {"op": "topk", "ids": [0], "k": 3, "exclude_self": "no"},
    {"op": "score", "u": [0], "v": [1, 2]},
    {"op": "score", "u": [0], "v": [1], "prob": 1},
]


@pytest.mark.parametrize("manifold", ["poincare", "lorentz"])
@pytest.mark.parametrize("scan_mode", ["two_stage", "fused"])
def test_serve_loop_matches_jax(artifacts, manifold, scan_mode):
    text = "\n".join(line if isinstance(line, str) else json.dumps(line)
                     for line in LINES) + "\n\n"
    art = artifacts[manifold]
    jout, tout = io.StringIO(), io.StringIO()
    jcli.run_serve(jcli.ServeConfig(artifact=art, scan_mode=scan_mode),
                   stdin=io.StringIO(text), stdout=jout)
    base = tregistry.default_registry().mark()
    closing = tcli.run_serve(
        tcli.ServeConfig(artifact=art, scan_mode=scan_mode, device="cpu"),
        stdin=io.StringIO(text), stdout=tout)
    jl = [json.loads(s) for s in jout.getvalue().splitlines()]
    tl = [json.loads(s) for s in tout.getvalue().splitlines()]
    assert len(tl) == len(jl) == len(LINES)
    for req, j, t in zip(LINES, jl, tl):
        assert set(t) == set(j), req
        if "error" in j:
            assert t["error"]["kind"] == j["error"]["kind"], req
        elif "neighbors" in j:
            _same_topk(t, j)
        else:
            np.testing.assert_allclose(t["scores"], j["scores"], atol=1e-6)
        assert t.get("request_id") == j.get("request_id")
    kinds = [t["error"]["kind"] for t in tl if "error" in t]
    assert kinds == ["parse"] + ["validation"] * 9
    # the batcher's counters are process-cumulative (the telemetry
    # registry): this loop's requests are the delta over its run
    assert closing["served"] == 4
    assert closing["requests"] - base["counters"].get("serve/requests",
                                                      0) == 8
    assert closing["scan_mode"] == scan_mode


def test_stats_op_and_cache(artifacts):
    lines = "\n".join(json.dumps(r) for r in (
        {"op": "topk", "ids": [3, 4], "k": 2},
        {"op": "topk", "ids": [4, 5], "k": 2},
        {"op": "stats", "request_id": "s"})) + "\n"
    out = io.StringIO()
    base = tregistry.default_registry().mark()["counters"]
    tcli.run_serve(tcli.ServeConfig(artifact=artifacts["poincare"],
                                    device="cpu", min_bucket=2),
                   stdin=io.StringIO(lines), stdout=out)
    st = json.loads(out.getvalue().splitlines()[-1])
    assert st["request_id"] == "s"
    # process-cumulative counters: the stats op's values less the mark
    d = {k: st[k] - base.get(f"serve/{k}", 0)
         for k in ("requests", "cache_hit", "cache_miss", "slots",
                   "padded_waste")}
    assert (d["requests"], d["cache_hit"], d["cache_miss"]) == (2, 1, 3)
    assert (d["slots"], d["padded_waste"]) == (4, 1)
    assert st["buckets"][0] == 2 and st["precision"] == "f32"


def test_cli_usage_errors(artifacts, capsys):
    art = artifacts["poincare"]
    for argv in (["query", f"artifact={art}", "ids=a,b", "device=cpu"],
                 ["query", f"artifact={art}", "device=cpu"],
                 ["query", "ids=0", "device=cpu"],
                 ["query", "bogus_flag=1", f"artifact={art}"],
                 ["query", f"artifact={art}", "ids=0", "k=999",
                  "device=cpu"],
                 ["query", f"artifact={art}", "ids=0",
                  "scan_mode=carry", "device=cpu"]):
        with pytest.raises(SystemExit):
            tcli.main(argv)


def test_cli_defaults_to_cuda(artifacts):
    """Without ``device=cpu`` the CLI wants the card; on a host without
    CUDA it stops with a usage error instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert tcli.ServeConfig().device == "cuda"
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.main(["query", f"artifact={artifacts['poincare']}", "ids=0"])
