"""The port's host prep against the JAX package, on the CPU: the native
C++ edge layout and BFS order (``hyperspace_torch/data/native.py``),
bitwise the JAX package's numpy oracles (``_prepare_edges_numpy``,
``_locality_order_python``) and the port's own, on random, empty,
self-loop-only, duplicate-edge and isolated-node inputs; the numpy
fallback without a compiler; the prep cache (one build then hits, a knob
change misses, a corrupt entry is rebuilt, the ``auto`` gate and its
switch); the csv and Planetoid loaders on layouts written by either
package (arrays bitwise equal); ``community_power_law_graph`` and
``load_graph``'s synthetic stand-ins bitwise JAX's.  Every comparison is
exact: host prep is integer work and parsing."""

import os
import pickle

import numpy as np
import pytest

from hyperspace_tpu.data import graphs as JG
from hyperspace_torch.data import graphs as TG
from hyperspace_torch.data import native
from hyperspace_torch.data import prep_cache as PC


def _cases():
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 400, (1500, 2))
    iso = rng.integers(0, 6, (30, 2))               # nodes 6..19 isolated
    return {
        "random": (rand, 400),
        "empty": (np.zeros((0, 2), np.int64), 7),
        "self_loops_only": (np.stack([np.arange(5)] * 2, axis=1), 5),
        "duplicates": (np.array([[0, 1], [0, 1], [1, 0], [2, 2], [3, 1],
                                 [3, 1], [1, 3]]), 4),
        "isolated": (iso, 20),
    }


CASES = _cases()
LAYOUT_FIELDS = ("senders", "receivers", "mask", "rev_perm", "deg")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("symmetrize,self_loops",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
@pytest.mark.parametrize("pad_multiple", [1, 64])
def test_native_prepare_edges_is_bitwise_the_numpy_oracles(
        case, symmetrize, self_loops, pad_multiple):
    edges, n = CASES[case]
    kw = dict(symmetrize=symmetrize, self_loops=self_loops,
              pad_multiple=pad_multiple)
    want = JG._prepare_edges_numpy(edges, n, **kw)
    ours = TG._prepare_edges_numpy(edges, n, **kw)
    got = native.prepare_edges(edges, n, **kw)
    for name, w, o, g in zip(LAYOUT_FIELDS, want, ours, got):
        if w is None:                      # rev_perm without symmetrize
            assert name == "rev_perm" and o is None
            continue
        assert g.dtype == w.dtype == o.dtype, name
        assert np.array_equal(g, w) and np.array_equal(o, w), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_locality_order_is_bitwise_the_python_walks(case):
    edges, n = CASES[case]
    want = JG._locality_order_python(edges, n)
    got = native.locality_order(edges, n)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(TG._locality_order_python(edges, n), want)
    assert np.array_equal(TG.locality_order(edges, n), want)
    assert np.array_equal(np.sort(got), np.arange(n))


def test_out_of_range_ids_raise_before_any_native_stage():
    bad = np.array([[0, 1], [2, 9]])
    for fn in (lambda: native.locality_order(bad, 5),
               lambda: TG.locality_order(bad, 5),
               lambda: TG.prepare(bad, 5, np.zeros((5, 2)), cache=False),
               lambda: TG.prepare(-bad, 5, np.zeros((5, 2)), cache=False)):
        with pytest.raises(IndexError, match="out of range"):
            fn()


def test_the_library_is_built_under_build_and_named_by_its_sources():
    assert native.available()
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.sep + os.path.join("build", "hyperspace_torch") + os.sep in path
    assert os.path.basename(path).startswith("hsdata-")
    assert not os.path.exists(os.path.join(
        os.path.dirname(native.__file__), "_native", "libhsdata.so"))


def _graph(n=500, m=2500, seed=3):
    edges, x, labels, k = TG.community_power_law_graph(n, m, 5, 8, seed=seed)
    return edges, x, labels, k


def test_prepare_records_its_path_and_falls_back_to_numpy(monkeypatch):
    edges, x, _, _ = _graph()
    kw = dict(pad_multiple=256, cluster=True, cluster_min_pair=8,
              cache=False)
    g = TG.prepare(edges, 500, x, **kw)
    assert g.prep == "native"
    jg = JG.prepare(edges, 500, x, **kw)
    for name in ("senders", "receivers", "edge_mask", "rev_perm", "deg"):
        assert np.array_equal(getattr(g, name), getattr(jg, name)), name

    def no_compiler():
        raise ImportError("no C++ compiler for the native host prep")

    monkeypatch.setattr(native, "load", no_compiler)
    assert not native.available()
    h = TG.prepare(edges, 500, x, **kw)
    assert h.prep == "numpy"
    for name in ("senders", "receivers", "edge_mask", "rev_perm", "deg"):
        assert np.array_equal(getattr(g, name), getattr(h, name)), name
    assert np.array_equal(TG.locality_order(edges, 500),
                          JG._locality_order_python(edges, 500))
    unsym = TG.prepare(edges, 500, x, symmetrize=False, cache=False)
    assert unsym.rev_perm is None and unsym.cluster_split is None


# --- the prep cache ------------------------------------------------------------


def _layout_equal(a, b):
    for name in ("senders", "receivers", "edge_mask", "rev_perm", "deg"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for pa, pb in zip(a.csr_plan, b.csr_plan):
        assert np.array_equal(pa, pb)
    assert a.prep == b.prep


def test_prep_cache_builds_once_then_hits(tmp_path, monkeypatch):
    edges, x, _, _ = _graph()
    pc = PC.PrepCache(str(tmp_path))
    builds = []
    real = TG._build_edge_layout
    monkeypatch.setattr(TG, "_build_edge_layout",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    g1 = TG.prepare(edges, 500, x, pad_multiple=256, cache=pc)
    g2 = TG.prepare(edges, 500, x, pad_multiple=256, cache=pc)
    assert (pc.misses, pc.hits, len(builds)) == (1, 1, 1)
    _layout_equal(g1, g2)
    # a knob change is another entry
    TG.prepare(edges, 500, x, pad_multiple=512, cache=pc)
    assert (pc.misses, pc.hits) == (2, 1)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and all(f.startswith("edge-layout-")
                                   and f.endswith(".pkl") for f in files)


def test_prep_cache_rebuilds_a_corrupt_entry(tmp_path):
    edges, x, _, _ = _graph()
    pc = PC.PrepCache(str(tmp_path))
    g1 = TG.prepare(edges, 500, x, pad_multiple=256, cache=pc)
    (entry,) = os.listdir(tmp_path)
    with open(tmp_path / entry, "wb") as f:
        f.write(b"not a pickle")
    g2 = TG.prepare(edges, 500, x, pad_multiple=256, cache=pc)
    assert (pc.misses, pc.hits) == (2, 0)
    _layout_equal(g1, g2)
    with open(tmp_path / entry, "rb") as f:      # rewritten whole
        assert pickle.load(f)["prep"] == "native"
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_prep_cache_serves_split_and_order(tmp_path):
    edges, x, labels, _ = _graph()
    pc = PC.PrepCache(str(tmp_path))
    runs = [TG.apply_locality_order(edges, x, labels, cache=pc)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert np.array_equal(a, b)
    splits = [TG.split_edges(edges, 500, x, seed=1, pad_multiple=256,
                             cache=pc) for _ in range(2)]
    for name in ("train_pos", "val_pos", "val_neg", "test_pos", "test_neg"):
        assert np.array_equal(getattr(splits[0], name),
                              getattr(splits[1], name)), name
    _layout_equal(splits[0].graph, splits[1].graph)
    # order, split and the train graph's layout: three builds, three hits
    assert (pc.misses, pc.hits) == (3, 3)
    kinds = sorted(f.split("-")[0] + "-" + f.split("-")[1]
                   for f in os.listdir(tmp_path))
    assert kinds == ["edge-layout", "local-order", "lp-split"]


def test_prep_cache_auto_gate_and_switch(tmp_path, monkeypatch):
    edges, x, _, _ = _graph()
    monkeypatch.setenv("HYPERSPACE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(PC, "_default", None)
    assert PC.default_root() == str(tmp_path)
    # under 200,000 raw edges "auto" never touches the disk
    TG.prepare(edges, 500, x, pad_multiple=256)
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(TG, "CACHE_AUTO_MIN_EDGES", 100)
    TG.prepare(edges, 500, x, pad_multiple=256)
    assert len(os.listdir(tmp_path)) == 1
    assert PC.default_cache().misses == 1
    monkeypatch.setenv("HYPERSPACE_GRAPH_CACHE", "0")
    TG.prepare(edges, 500, x, pad_multiple=128)
    assert len(os.listdir(tmp_path)) == 1
    TG.prepare(edges, 500, x, pad_multiple=128, cache=True)  # forced
    assert len(os.listdir(tmp_path)) == 2
    with pytest.raises(ValueError, match="cache"):
        PC.resolve("sometimes", auto_ok=True)


def test_prep_cache_keys_on_the_ports_own_producers(monkeypatch):
    monkeypatch.delenv("HYPERSPACE_CACHE_DIR", raising=False)
    root = PC.default_root()
    assert root.endswith(os.path.join(".cache", "graphprep_torch"))
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(PC.__file__)))
    for rel in PC._CODE_FILES:
        assert os.path.exists(os.path.join(pkg, rel)), rel
    assert any(rel.endswith("graphprep.cc") for rel in PC._CODE_FILES)
    # typed keys: the int 1 and the string "1" never collide
    assert PC.key_hash("k", (1,)) != PC.key_hash("k", ("1",))


# --- loaders and writers -------------------------------------------------------


def _arrays_equal(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(u, np.ndarray):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert np.array_equal(np.ascontiguousarray(u).view(np.uint8),
                                  np.ascontiguousarray(v).view(np.uint8))
        else:
            assert u == v


def test_ogb_layouts_written_by_either_package_load_the_same(tmp_path):
    edges, x, labels, _ = TG.community_power_law_graph(700, 4000, 6, 16,
                                                       seed=5)
    x[0, :4] = [0.0, -0.0, 1.25e-7, 123456.5]       # formatting edge cases
    JG.write_ogb_csv_layout(str(tmp_path / "jax"), edges, x, labels)
    TG.write_ogb_csv_layout(str(tmp_path / "port"), edges, x, labels)
    loads = {}
    for who in ("jax", "port"):
        root = str(tmp_path / who)
        want = JG.load_ogbn_arxiv(root)
        got = TG.load_ogbn_arxiv(root)
        _arrays_equal(got, want)
        loads[who] = got
    _arrays_equal(loads["jax"], loads["port"])
    e, xl, lab, k = loads["port"]
    assert np.array_equal(e, edges) and np.array_equal(lab, labels)
    assert k == labels.max() + 1
    # %.6g, then an f32 rounding
    np.testing.assert_allclose(xl, x, rtol=5e-6 + 2.0 ** -23)
    for name in ("edge.csv", "node-feat.csv", "node-label.csv"):
        with open(tmp_path / "jax" / "raw" / name, "rb") as f:
            jtext = f.read()
        with open(tmp_path / "port" / "raw" / name, "rb") as f:
            assert f.read() == jtext, name


def test_cora_layout_loads_the_same_in_both_packages(tmp_path):
    edges, x, labels, k = TG.community_power_law_graph(300, 1200, 7, 20,
                                                       seed=2)
    xb = (x > 0.5).astype(np.float32)               # Cora's binary words
    TG.write_cora_layout(str(tmp_path), edges, xb, labels)
    with open(tmp_path / "cora.cites", "a") as f:
        f.write("299\t5000\n")                       # an unknown paper id
    want = JG.load_cora(str(tmp_path))
    got = TG.load_cora(str(tmp_path))
    _arrays_equal(got, want)
    assert np.array_equal(got[0], edges) and np.array_equal(got[1], xb)
    assert got[3] == len(np.unique(labels))
    # labels numbered by first appearance: a relabeling of the input's
    first = {}
    for lab in labels.tolist():
        first.setdefault(lab, len(first))
    assert np.array_equal(got[2], np.array([first[v] for v in labels]))


@pytest.mark.parametrize("name", ["cora", "ogbn-arxiv"])
def test_load_graph_matches_jax(tmp_path, name):
    want = JG.load_graph(name, None, num_nodes=400)
    got = TG.load_graph(name, None, num_nodes=400)
    assert got[-1] == want[-1] == "synthetic"
    _arrays_equal(got[:-1], want[:-1])
    # an empty root falls back too; files under it are read from disk
    assert TG.load_graph(name, str(tmp_path), num_nodes=64)[-1] == \
        "synthetic"
    edges, x, labels, _ = TG.community_power_law_graph(200, 800, 4, 6)
    if name == "cora":
        TG.write_cora_layout(str(tmp_path), edges, x, labels)
    else:
        TG.write_ogb_csv_layout(str(tmp_path), edges, x, labels)
    got = TG.load_graph(name, str(tmp_path))
    assert got[-1] == "disk"
    _arrays_equal(got[:-1], JG.load_graph(name, str(tmp_path))[:-1])


@pytest.mark.parametrize("kw", [dict(num_nodes=3000, num_edges=20000,
                                     num_classes=7, feat_dim=16, seed=0),
                                dict(num_nodes=1500, num_edges=9000,
                                     num_classes=40, feat_dim=8, seed=4,
                                     sub_size=50)])
def test_community_power_law_graph_is_bitwise_jax(kw):
    _arrays_equal(TG.community_power_law_graph(**kw),
                  JG.community_power_law_graph(**kw))
