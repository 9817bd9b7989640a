"""How the flash backward kernels cut the other side into parts
(``hyperspace_torch.kernels.attention.split_count``), on the CPU.

A launch of dq (or dk/dv) has ``blocks`` blocks of 64 rows a part and
streams ``tiles`` 64-row tiles of the other side; the parts differ by one
tile at most.  The count must leave no part empty, put two blocks on
every streaming multiprocessor where the tiles allow, and follow the
kernel's occupancy at the HyboNet shapes of an H100 (132 SMs).
"""

import pytest

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
