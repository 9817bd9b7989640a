"""Chunked (``scan_chunk``) HyboNet and HGCN steps and the device-side
counters that let a CUDA graph replay them, on the CPU.

On the CPU a chunk is a plain loop of the step (``train/loop.py``), so a
``scan_chunk=4`` run of the CLI must be bitwise the ``scan_chunk=1`` run
of the same rounded budget: parameters, optimizer moments and counts,
generator states, step counts, printed results.  HGCN link prediction
runs under ``torch.use_deterministic_algorithms``: its decoder's
``index_put_`` backward sums in thread order on the CPU otherwise.

The counters moved to the device: ``AdamW``'s update count (its bias
corrections in float64 on the device, rounded once) is held bitwise
against the Python-count update it replaces over 5 steps, with and
without clipping, and ``GradAccumulation``'s device choice against the
Python-branch version at k = 2 and 3.  A checkpoint written before the
move (counts as Python numbers) restores into the new state.  The
graphed replays themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 59-62).
"""

import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch
import torch.utils._pytree as pytree

from hyperspace_torch.cli import train as tcli
from hyperspace_torch.data import graphs as G
from hyperspace_torch.models import hybonet
from hyperspace_torch.optim.accum import GradAccumulation
from hyperspace_torch.optim.adamw import AdamW
from hyperspace_torch.train import checkpoint as TC


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return json.loads(buf.getvalue().splitlines()[-1])


def _same(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def cora(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cora"))
    e, x, lab, _ = G.community_power_law_graph(
        num_nodes=300, num_edges=900, num_classes=5, feat_dim=16, seed=3)
    G.write_cora_layout(d, e, (x > 1.5).astype("float32"), lab)
    return d


CASES = {
    "hybonet": ["hybonet", "dim=16", "num_heads=2", "num_layers=1",
                "batch_size=8"],
    "hybonet_accum2": ["hybonet", "dim=16", "num_heads=2", "num_layers=1",
                       "batch_size=8", "accum=2"],
    "hgcn_lp": ["hgcn", "task=lp", "hidden_dims=[8, 4]"],
    "hgcn_nc": ["hgcn", "task=nc", "hidden_dims=[8, 4]"],
    "hgcn_att": ["hgcn", "task=lp", "hidden_dims=[8, 4]", "use_att=true"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_chunk_is_bitwise_the_plain_steps(case, tmp_path, cora,
                                               deterministic):
    """``steps=6 scan_chunk=4`` rounds the budget up to 8 and runs two
    chunks; ``steps=8 scan_chunk=1`` is the same run step by step."""
    argv = CASES[case] + ["device=cpu", "ckpt_every=4", "eval_every=2"]
    if case.startswith("hgcn"):
        argv += ["dataset=cora", f"data_root={cora}", "graph_cache=false"]
    out = []
    for name, steps, k in (("one", 8, 1), ("four", 6, 4)):
        log = tmp_path / f"{name}.jsonl"
        res = _cli(argv + [f"steps={steps}", f"scan_chunk={k}",
                           f"ckpt_dir={tmp_path / name}", f"log={log}"])
        tree, step = TC.restore_params_only(str(tmp_path / name))
        out.append((res, tree, step))
    (r1, t1, s1), (r4, t4, s4) = out
    r1.pop("seconds", None)
    r4.pop("seconds", None)
    assert s1 == s4 == 8 and r1 == r4 and _same(t1, t4)
    train = t1["train"]
    assert int(train["step"]) == 8
    count = t1["opt"]["inner"]["count"] if case.endswith("accum2") \
        else t1["opt"]["count"]
    assert int(count) == (4 if case.endswith("accum2") else 8)


class PythonCountAdamW(AdamW):
    """The update before the count moved to the device: a Python count,
    Python-float bias corrections."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.count = 0

    @torch.no_grad()
    def step(self, grads=None):
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm)
                     for g in grads]
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.wd * p
            p.add_(-self.lr * u)


class PythonGradAccumulation:
    """``GradAccumulation`` before its counts moved to the device."""

    def __init__(self, inner, k):
        self.inner, self.k, self.n = inner, k, 0
        self.acc = [torch.zeros_like(p) for p in inner.params]

    @torch.no_grad()
    def step(self, grads):
        for a, g in zip(self.acc, grads):
            a.copy_(a + (g - a) / (self.n + 1))
        if self.n == self.k - 1:
            self.inner.step(self.acc)
            for a in self.acc:
                a.zero_()
        self.n = (self.n + 1) % self.k


def _params(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(37, 5, generator=g),
            "b": torch.randn(11, generator=g) * 1e-3,
            "z": torch.randn(3, 4, 2, generator=g, dtype=torch.float64)}


def _grads(opt, gen):
    return [torch.randn(p.shape, generator=gen, dtype=p.dtype) * 0.1
            for p in opt.params]


@pytest.mark.parametrize("max_norm", [None, 0.5])
def test_adamw_device_count_is_bitwise_the_python_count(max_norm):
    new = AdamW(_params(0), 1e-2, 1e-2, max_norm)
    old = PythonCountAdamW(_params(0), 1e-2, 1e-2, max_norm)
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        g = _grads(new, gen)
        new.step([t.clone() for t in g])
        old.step(g)
    for a, b in zip(new.params + new.mu + new.nu,
                    old.params + old.mu + old.nu):
        assert torch.equal(a, b)
    assert new.count.dtype == torch.int64 and int(new.count) == 5


@pytest.mark.parametrize("form", ["host", "device", "mixed"])
@pytest.mark.parametrize("k", [2, 3])
def test_grad_accumulation_on_the_device_is_bitwise(k, form):
    """The eager step (chosen on the host), the step a graph captures
    (chosen on the device) and the two in turn (the host form reading
    the count back after a device step) are each bitwise the Python
    version."""
    new = GradAccumulation(AdamW(_params(2), 1e-2, 1e-2), k)
    old = PythonGradAccumulation(PythonCountAdamW(_params(2), 1e-2, 1e-2), k)
    gen = torch.Generator().manual_seed(3)
    for i in range(2 * k + 1):
        g = _grads(new, gen)
        on_device = form == "device" or (form == "mixed" and i % 3 == 1)
        (new.step_on_device if on_device else new.step)(
            [t.clone() for t in g])
        old.step(g)
        for a, b in zip(new.params + new.acc, old.inner.params + old.acc):
            assert torch.equal(a, b), i
    assert int(new.gradient_step) == 2 and int(new.mini_step) == 1
    assert int(new.inner.count) == old.inner.count == 2


def test_checkpoint_with_number_counts_still_restores(tmp_path):
    """A checkpoint whose counts are Python numbers (the format before
    they moved to the device) restores into the device counters."""
    cfg = hybonet.HyboNetConfig(vocab_size=20, num_classes=3, max_len=6,
                                dim=8, num_heads=2, num_layers=1,
                                batch_size=4)
    model, opt, train = hybonet.init_model(cfg, 0, "cpu")
    opt = GradAccumulation(opt, 2)
    toks = torch.randint(0, 20, (10, 6), generator=torch.Generator()
                         .manual_seed(0))
    mask, labels = torch.ones(10, 6, dtype=torch.bool), torch.arange(10) % 3
    for _ in range(3):
        hybonet.train_step_sampled(model, opt, train, toks, mask, labels)
    tree = TC.to_tree(tcli.ModuleState(model, opt, train))
    tree = TC._to_host(tree)
    tree["train"]["step"] = 3
    tree["opt"]["mini_step"], tree["opt"]["gradient_step"] = 1, 1
    tree["opt"]["inner"]["count"] = 1
    os.makedirs(tmp_path / "3")
    torch.save(tree, tmp_path / "3" / TC.STATE_FILE)
    m2, o2, t2 = hybonet.init_model(cfg, 5, "cpu")
    st = tcli.ModuleState(m2, GradAccumulation(o2, 2), t2)
    st, step = TC.CheckpointManager(str(tmp_path)).restore(st)
    assert step == 3 and int(st.train.step) == 3
    assert (int(st.opt.mini_step), int(st.opt.gradient_step),
            int(st.opt.inner.count)) == (1, 1, 1)
    assert st.opt.inner.count.dtype == torch.int64
    for a, b in zip(model.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(train.generator.get_state(),
                       st.train.generator.get_state())
