"""The grid policies of K1 and K5, pinned on the CPU.

``pool_ctas`` (``ops/pool_kernel.py``) gives K1's CTAs per batch row, the
size of the row's thread-block cluster; ``lut_grid``
(``ann/lut_kernel.py``) gives K5's rows per CTA tile and probed cells per
CTA. Both are plain functions of the shapes and the card's SM count, so
they are checked here at the H100's 132 SMs and at edge shapes, as
``tests/test_torch_longbag.py`` pins ``stream_ctas`` for K2-K4.
"""

import pytest

from code2vec_tpu_torch.ann.lut_kernel import CTAS_PER_SM, TILE_ALIGN, lut_grid
from code2vec_tpu_torch.ops.pool_kernel import (
    CONTEXTS_PER_CTA,
    MAX_CLUSTER,
    RESIDENT_CTAS_PER_SM,
    pool_ctas,
)

H100_SMS = 132


@pytest.mark.parametrize("B,L,ctas", [
    (1, 1, 1), (1, 37, 1), (1, 64, 1), (1, 65, 2), (1, 200, 4), (1, 257, 5), (1, 2048, 8),
    (8, 200, 4), (64, 37, 1), (64, 200, 4), (64, 2048, 8), (200, 200, 4), (200, 2048, 8),
    (10**4, 2048, 8),
])
def test_pool_ctas_at_the_h100(B, L, ctas):
    assert pool_ctas(B, L, H100_SMS) == ctas


@pytest.mark.parametrize("L", [1, 31, 32, 33, 200, 257, 2048, 10**6])
@pytest.mark.parametrize("B", [1, 5, 64, 200])
def test_pool_ctas_bounds(B, L):
    """1..MAX_CLUSTER CTAs, never more than the bag has rounds of
    CONTEXTS_PER_CTA contexts, and the same at every batch size: the
    cluster fixes the order in which a row's partials merge, so a row's
    bits must not depend on the micro-batch it rides in."""
    ctas = pool_ctas(B, L, H100_SMS)
    assert 1 <= ctas <= MAX_CLUSTER
    assert ctas <= -(-L // CONTEXTS_PER_CTA)
    assert ctas == pool_ctas(1, L, H100_SMS)


def test_pool_ctas_one_cta_when_the_batch_fills_the_card():
    """A batch that fills the card no longer drops a row to one CTA (a
    large batch runs in more waves instead); only a card with fewer
    resident CTAs than a cluster caps it."""
    full = H100_SMS * RESIDENT_CTAS_PER_SM
    assert pool_ctas(full, 2048, H100_SMS) == MAX_CLUSTER
    assert pool_ctas(full // 2, 2048, H100_SMS) == MAX_CLUSTER
    assert pool_ctas(1, 2048, 1) == RESIDENT_CTAS_PER_SM  # a one-SM card


@pytest.mark.parametrize("Q,P,grid", [
    (1, 8, (96, 1)), (1, 16, (192, 1)), (8, 8, (672, 1)), (8, 16, (896, 1)),
    (64, 8, (2688, 1)), (64, 16, (2688, 3)), (64, 32, (2688, 7)),
])
def test_lut_grid_at_the_h100_index(Q, P, grid):
    """chip_smoke's index (capacity 2,688) at its K5 shapes."""
    assert lut_grid(Q, P, 2688, H100_SMS) == grid


@pytest.mark.parametrize("C", [1, 31, 100, 128, 2688, 3000])
@pytest.mark.parametrize("Q,P", [(1, 1), (1, 16), (8, 32), (64, 16), (65535, 1)])
def test_lut_grid_covers_each_cell_in_equal_tiles(Q, P, C):
    T, G = lut_grid(Q, P, C, H100_SMS)
    assert T % TILE_ALIGN == 0 and 1 <= G <= P
    tiles = -(-C // T)
    assert (tiles - 1) * T < C <= tiles * T  # no empty tile
    assert T == -(-(-(-C // tiles)) // TILE_ALIGN) * TILE_ALIGN  # the cell's share, aligned
    if G > 1:
        assert tiles == 1  # several cells per CTA only when a CTA holds a whole cell
    # the card is filled whenever the call has the tiles for it
    assert tiles * -(-P // G) * Q >= min(tiles * P * Q, H100_SMS)
    assert T * G <= max(T, -(-(Q * P * C) // (CTAS_PER_SM * H100_SMS)))


def test_lut_grid_one_query_spreads_over_the_card():
    T, G = lut_grid(1, 16, 2688, H100_SMS)
    assert G == 1 and -(-2688 // T) * 16 >= H100_SMS
