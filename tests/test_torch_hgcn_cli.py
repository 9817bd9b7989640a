"""``python -m hyperspace_torch.cli.train hgcn`` on the CPU (``device=cpu``):
link prediction, node classification, the attention arm and learned
curvature from Cora-format and OGB-csv layouts on disk, the JSON line it
prints, its per-step log, its exits for what is not ported, and its data
pipeline (load → relabel → split or prepare) against the JAX package's
on the same files: the split's pairs and the training layout bitwise
equal.  Also the kernel launches a step of each path makes, counted on
the CPU at the wrappers, against the per-step counts ``chip_smoke.py``
holds the card's runs to."""

import collections
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import chip_smoke
from hyperspace_tpu.data import graphs as JG
from hyperspace_torch.cli import train as tcli
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.models import hgcn as th
from hyperspace_torch.nn import mlr as tnm
from hyperspace_torch.nn import scatter as tsc

N, M, K, F = 400, 2000, 6, 24
LP_KEYS = ["dataset", "loss", "prep", "roc_auc", "seconds", "source",
           "task", "workload"]
NC_KEYS = ["dataset", "loss", "prep", "seconds", "source", "task",
           "test_acc", "test_f1", "val_acc", "workload"]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("hgcn_cli")
    edges, x, labels, _ = TG.community_power_law_graph(N, M, K, F, seed=7)
    TG.write_cora_layout(str(root / "cora"), edges, x, labels)
    TG.write_ogb_csv_layout(str(root / "ogb"), edges, x, labels)
    return {"cora": str(root / "cora"), "ogbn-arxiv": str(root / "ogb")}


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("extra,keys", [
    (["task=lp"], LP_KEYS),
    (["task=nc"], NC_KEYS),
    (["use_att=true"], LP_KEYS),
    (["task=nc", "learn_c=true", "reorder=bfs"], NC_KEYS),
    (["dataset=ogbn-arxiv", "reorder=community", "learn_c=true",
      "agg_dtype=bfloat16", "decoder_dtype=bfloat16"], LP_KEYS)],
    ids=["lp", "nc", "att", "nc-learn_c-bfs", "ogb-community-learn_c-bf16"])
def test_cli_hgcn_trains_from_disk(layouts, tmp_path, extra, keys):
    dataset = next((a.split("=")[1] for a in extra
                    if a.startswith("dataset=")), "cora")
    log = str(tmp_path / "log.jsonl")
    out = _run(["hgcn", f"data_root={layouts[dataset]}", "steps=4",
                "device=cpu", "hidden_dims=[16, 8]", f"log={log}",
                "eval_every=1", *extra]
               + ([] if dataset != "cora" else ["dataset=cora"]))
    assert sorted(out) == keys
    assert (out["workload"], out["source"], out["dataset"]) == (
        "hgcn", "disk", dataset)
    assert out["prep"] == "native" and out["seconds"] > 0
    assert np.isfinite(out["loss"])
    with open(log) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert losses[-1] == out["loss"]
    if "roc_auc" in out:
        assert 0.0 <= out["roc_auc"] <= 1.0
    else:
        assert 0.0 <= out["test_acc"] <= 1.0


def test_cli_hgcn_config_from_the_yaml(layouts, monkeypatch):
    """``configs/hgcn_arxiv_lp.yaml`` as the CLI reads it: hidden (128,
    32), Lorentz, bf16 messages and decoder, the BFS relabeling."""
    seen = {}
    real = th.init_lp

    def spy(cfg, g, seed=0, device="cuda"):
        seen["cfg"] = cfg
        return real(cfg, g, seed, device)

    monkeypatch.setattr(th, "init_lp", spy)
    out = _run(["hgcn", "--yaml", os.path.join("configs",
                                                "hgcn_arxiv_lp.yaml"),
                f"data_root={layouts['ogbn-arxiv']}", "steps=1",
                "device=cpu", "graph_cache=false"])
    cfg = seen["cfg"]
    assert out["task"] == "lp" and out["dataset"] == "ogbn-arxiv"
    assert tuple(cfg.hidden_dims) == (128, 32) and cfg.kind == "lorentz"
    assert cfg.agg_dtype is torch.bfloat16
    assert cfg.decoder_dtype is torch.bfloat16
    assert (cfg.feat_dim, cfg.lr, cfg.clip_norm) == (F, 1e-2, 0.0)
    pairs = tcli.read_flat_yaml(os.path.join("configs", "hgcn_arxiv_lp.yaml"))
    run, wl = tcli.split_overrides(pairs, tcli.RunConfig())
    assert run.steps == 2000 and wl["reorder"] == "true"


@pytest.mark.parametrize("argv,match", [
    (["--yaml", os.path.join("configs", "hgcn_sampled_nc.yaml")],
     "sampled=true.*not ported"),
    (["multihost=true"], "meshes are not ported"),
    (["scan_chunk=2"], "scan_chunk=2.*not ported"),
    (["task=link"], "task='link'"),
    (["reorder=spectral"], "reorder='spectral'"),
    (["graph_cache=sometimes"], "graph_cache"),
    (["hidden=3"], "unknown option 'hidden'")])
def test_cli_hgcn_exits_for_what_it_does_not_take(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(["hgcn", "device=cpu", "steps=1", *argv])


def test_cli_hgcn_wants_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["hgcn", "steps=1"])


@pytest.mark.parametrize("dataset", ["cora", "ogbn-arxiv"])
@pytest.mark.parametrize("reorder", ["bfs", "community"])
def test_cli_data_pipeline_matches_jax(layouts, dataset, reorder):
    """The CLI's host path (load_graph → apply_locality_order →
    split_edges / prepare) gives JAX's arrays on the same files; the
    held-out negatives are drawn by each package's own sampler."""
    root = layouts[dataset]
    jd, td = JG.load_graph(dataset, root), TG.load_graph(dataset, root)
    assert td[-1] == jd[-1] == "disk"
    je, jx, jl, _ = JG.apply_locality_order(*jd[:3], method=reorder,
                                            cache=False)
    te, tx, tl, _ = TG.apply_locality_order(*td[:3], method=reorder,
                                            cache=False)
    for a, b in ((je, te), (jx, tx), (jl, tl)):
        assert np.array_equal(a, b)
    cmp_ = TG.cluster_min_pair_for(False)
    js_ = JG.split_edges(je, N, jx, seed=0, cluster_min_pair=cmp_,
                         cache=False)
    ts_ = TG.split_edges(te, N, tx, seed=0, cluster_min_pair=cmp_,
                         cache=False)
    for name in ("train_pos", "val_pos", "test_pos"):
        assert np.array_equal(getattr(js_, name), getattr(ts_, name)), name
    for name in ("senders", "receivers", "edge_mask", "rev_perm", "deg"):
        assert np.array_equal(getattr(js_.graph, name),
                              getattr(ts_.graph, name)), name
    # task=nc: the whole graph with its masks
    masks = JG.node_split_masks(N, seed=0)
    for w, g in zip(masks, TG.node_split_masks(N, seed=0)):
        assert np.array_equal(w, g)
    fields = dict(labels=tl, num_classes=K, train_mask=masks[0],
                  val_mask=masks[1], test_mask=masks[2], cluster_min_pair=cmp_,
                  cache=False)
    jg = JG.prepare(je, N, jx, **fields)
    tg = TG.prepare(te, N, tx, **fields)
    for name in ("senders", "receivers", "edge_mask", "rev_perm", "deg",
                 "labels", "train_mask", "x"):
        assert np.array_equal(getattr(jg, name), getattr(tg, name)), name


# --- launches a step ---------------------------------------------------------

WRAPPERS = ("csr_segment_sum", "cluster_aggregate", "csr_segment_reduce_1d",
            "csr_att_bwd_edges", "cluster_att_fwd", "cluster_att_bwd")


@pytest.fixture
def counts(monkeypatch):
    """Calls of each kernel wrapper, counted where the layers call them."""
    got = collections.Counter()

    def counted(mod, name):
        real = getattr(mod, name)

        def f(*a, **k):
            got[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, f)

    for name in WRAPPERS:
        counted(tsc, name)
    counted(tnm, "hyp_mlr")
    return got


def _launches(counts, argv, steps):
    counts.clear()
    _run(argv + [f"steps={steps}"])
    return {n: counts[n] for n in set(WRAPPERS) | {"hyp_mlr"}}


@pytest.mark.parametrize("extra,per_step,per_eval,cluster", [
    ([], chip_smoke.CLI_LP_PER_STEP, chip_smoke.CLI_LP_PER_EVAL, True),
    (["task=nc"], chip_smoke.NC_PER_STEP, chip_smoke.NC_PER_EVAL, True),
    (["use_att=true"], chip_smoke.CLI_ATT_PER_STEP,
     chip_smoke.CLI_ATT_PER_EVAL, False)],
    ids=["lp", "nc", "att"])
def test_launches_a_step_are_the_smokes(layouts, monkeypatch, counts, extra,
                                        per_step, per_eval, cluster):
    """Two runs, of 1 and 3 steps: the difference is two steps' launches
    and what is left an evaluation's.  The arxiv layouts have a cluster
    split (≥ 200,000 edges); here the split is forced at a low density
    threshold, the Cora layout's attention run has none, as on the card."""
    if cluster:
        monkeypatch.setattr(TG, "CLUSTER_AUTO_MIN_EDGES", 0)
        monkeypatch.setattr(TG, "cluster_min_pair_for", lambda att: 4)
    argv = ["hgcn", "dataset=cora", f"data_root={layouts['cora']}",
            "device=cpu", "hidden_dims=[16, 8]", *extra]
    one, three = _launches(counts, argv, 1), _launches(counts, argv, 3)
    for name in set(WRAPPERS) | {"hyp_mlr"}:
        step = (three[name] - one[name]) / 2
        assert step == per_step.get(name, 0), name
        assert one[name] - step == per_eval.get(name, 0), name


def test_planned_step_launches_are_the_smokes(monkeypatch, counts):
    edges, x, _, _ = TG.community_power_law_graph(N, M, K, F, seed=7)
    split = TG.split_edges(edges, N, x, seed=0, cluster_min_pair=4,
                           cache=False)
    g = split.graph
    g.cluster_split = TG.build_cluster_split(
        g.senders, g.receivers, g.edge_mask, g.deg, N, min_pair_edges=4,
        rev_perm=g.rev_perm)
    cfg = th.HGCNConfig(feat_dim=F, hidden_dims=(16, 8))
    model, opt, state = th.init_lp(cfg, g, seed=0, device="cpu")
    ga = TG.to_device(g, "cpu")
    neg_u, neg_plan = th.make_static_negatives(N, 500, device="cpu")
    counts.clear()
    th.train_step_lp_planned(model, opt, N, state, ga, neg_u, neg_plan)
    for name in WRAPPERS:
        assert counts[name] == chip_smoke.PLANNED_PER_STEP.get(name, 0), name


def test_bench_runs_the_clis_step():
    """``hgcn_bench``'s ``step="lp"`` (``--step lp``): the CLI's
    ``train_step_lp`` beside the default planned pairs step."""
    from hyperspace_torch.benchmarks import hgcn_bench as TB

    out = TB.run_hgcn_bench(steps=2, num_nodes=600, device="cpu", step="lp")
    assert out["step"] == "lp" and len(out["losses"]) == 2
    assert np.all(np.isfinite(out["losses"]))
    assert TB.run_hgcn_bench(steps=1, num_nodes=600,
                             device="cpu")["step"] == "pairs"
    with pytest.raises(ValueError, match="step"):
        TB.setup_lp(600, device="cpu", step="planned")
    assert TB.main(["--steps", "1", "--num-nodes", "300", "--device", "cpu",
                    "--step", "lp"]) == 0
