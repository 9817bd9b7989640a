"""How the flash backward kernels cut the other side into parts
(``hyperspace_torch.kernels.attention.split_count``), and how their dτ is
held, on the CPU.

A launch of dq (or dk/dv) has ``blocks`` blocks of 64 rows a part and
streams ``tiles`` 64-row tiles of the other side; the parts differ by one
tile at most.  The count must leave no part empty, put two blocks on
every streaming multiprocessor where the tiles allow, and follow the
kernel's occupancy at the HyboNet shapes of an H100 (132 SMs).
"""

import numpy as np
import pytest
import torch

from hyperspace_torch.kernels import attention as A
from hyperspace_torch.kernels.attention import split_count

SMS = 132


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("blocks,tiles", [
    (1, 1), (1, 2), (3, 7), (22, 33), (64, 32), (256, 64), (256, 1),
    (2048, 2), (4096, 16), (2, 4096), (131, 3), (1000, 1000)])
def test_parts_are_never_empty_and_fill_the_card(blocks, tiles, per_sm):
    s = split_count(blocks, tiles, SMS, per_sm)
    assert 1 <= s <= max(tiles, 1)
    # part z takes tiles [z·T/s, (z+1)·T/s): none is empty when s ≤ T
    assert all((z + 1) * tiles // s > z * tiles // s for z in range(s))
    if tiles > 1:
        assert blocks * s >= min(2 * SMS, blocks * tiles)
    assert split_count(blocks, tiles, SMS, per_sm) == s


@pytest.mark.parametrize("blocks,tiles,per_sm,want", [
    (4 * 64, 64, 3, 3),      # long leg, dq: 3 blocks an SM
    (4 * 64, 64, 2, 2),      # long leg, dk/dv: 2 blocks an SM
    (1024 * 2, 2, 3, 1),     # bench leg: the card is full already
    (1024 * 2, 2, 2, 1),
    (256, 1, 3, 1),          # the CLI's 32-token sequences: one tile
])
def test_parts_at_the_hybonet_shapes(blocks, tiles, per_sm, want):
    assert split_count(blocks, tiles, SMS, per_sm) == want


# chip_smoke.py's FLASH_GRAD_TOL, the JAX package's tier for its kernel
# (tests/kernels/test_attention.py, test_flash_backward_matches_twin)
FLASH_GRAD_TOL = 2e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dtau_of_a_cancelling_head_needs_the_normwise_bound(seed):
    """dτ = −Σ dσ·σ / τ over a head's pairs.  Head 1 has one valid key a
    row, so its softmax rows are constant and every dσ is 0: its dτ is 0
    exactly, in the dense twin at float64 and at float32 alike.  The
    flash backward sums dσ·σ in float32 from σ − lse and the epilogue's
    rounded s (``flash_dq_plain``, as the kernel does), so its dτ is
    rounding noise.  That fails a bound relative to the head's own dτ
    (``FLASH_GRAD_TOL·|dτ₆₄| + 4·|twin₃₂ − dτ₆₄|``, zero here) and
    passes the JAX package's norm-wise bound over the case."""
    rng = np.random.default_rng(seed)
    n, d = 48, 5

    def rows():
        sp = rng.standard_normal((2, n, d - 1)) * 0.5
        t = np.sqrt(1.0 + np.sum(sp * sp, axis=-1, keepdims=True))
        return np.concatenate([t, sp], axis=-1)[None]

    q, k, v = rows(), rows(), rows()
    g = rng.standard_normal((1, 2, n, d))
    mask = np.ones((1, 2, n, n), bool)
    mask[0, 1] = np.eye(n, dtype=bool)
    beta, tau = np.array([0.3, 30.0]), np.array([1.3, 1.7])
    dtau = {}
    for kind in ("flash", "twin", "twin64"):
        dt = torch.float64 if kind == "twin64" else torch.float32
        ins = [torch.tensor(x, dtype=dt, requires_grad=True)
               for x in (q, k, v)]
        ta = torch.tensor(tau, dtype=dt)[:, None, None].requires_grad_()
        be = torch.tensor(beta, dtype=dt)[:, None, None].requires_grad_()
        m = torch.tensor(mask)
        if kind == "flash":
            o = A.flash_attention(*ins, 1.0, beta=be, tau=ta, mask=m)
        else:
            o = A.flash_attention_plain(*ins, 1.0, be, ta, m)
        (o * torch.tensor(g, dtype=dt)).sum().backward()
        dtau[kind] = ta.grad.double().flatten()
    t64 = dtau["twin64"]
    assert t64[1] == 0 and dtau["twin"][1] == 0 and dtau["flash"][1] != 0
    err = (dtau["flash"] - t64).abs()
    per_head = FLASH_GRAD_TOL * t64.abs() + 4 * (dtau["twin"] - t64).abs()
    assert bool(err[1] > per_head[1])
    assert float(err.max()) <= FLASH_GRAD_TOL * max(float(t64.abs().max()),
                                                   1e-3)
