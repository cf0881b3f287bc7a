"""Launch geometry of the port's int8 kernels: pure functions of the shapes,
computed in the wrappers and pinned here on the CPU (the kernels themselves
are held against their plain versions on the card by test_torch_cuda.py)."""

import pytest
import torch

from ladine_tpu_torch.kernels import int8_eps_fused as k5


@pytest.mark.parametrize("k, threads", [(16, 32), (64, 32), (80, 32), (272, 32), (512, 32), (528, 64),
                                        (4096, 256), (8192, 512)])
def test_lin1_pass_takes_one_row_a_block_16_k_a_thread(k, threads):
    assert k5.lin1_threads(k) == threads
    assert threads % 32 == 0 and threads * 16 >= k > (threads - 32) * 16


@pytest.mark.parametrize("k", [0, 8, 40, 4100, 16 * 513])
def test_lin1_pass_refuses_k_it_does_not_take(k):
    with pytest.raises(ValueError, match="lin1 pass takes K"):
        k5.lin1_threads(k)


def test_lin1_check_refuses_a_k_past_one_block_before_any_launch():
    k = 16 * 513
    f = torch.zeros(1, 2, k)
    args = (f, torch.zeros(1, 2, 4), torch.zeros(1, 4, k), torch.zeros(1, k), torch.zeros(1, k))
    with pytest.raises(ValueError, match="lin1 pass takes K"):
        k5._check_lin1(*args)
    assert k5._check_lin1(f[:, :, :4096].contiguous(), args[1], args[2][:, :, :4096].contiguous(),
                          args[3][:, :4096].contiguous(), args[4][:, :4096].contiguous()) == (1, 2, 4096, 4, 256)


import collections  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

from ladine_tpu_torch.kernels import fused_linear as fl  # noqa: E402
from ladine_tpu_torch.kernels import int8_linear as k4  # noqa: E402

# (row_tiles, col_tiles, steps, tiles, grid, chunks), waves
GEMM_PLANS = [
    ((5, 160, 4096, 4096), (1, 32, 32, 160, 132, 4), 2),  # the path at batch 8: 132 whole, 28 in quarters
    ((5, 20, 4096, 4096), (1, 32, 32, 160, 132, 4), 2),  # batch 1: one live slab a tile
    ((5, 161, 4096, 4096), (1, 32, 32, 160, 132, 4), 2),  # still one 192-row tile
    ((5, 193, 4096, 4096), (2, 32, 32, 320, 132, 2), 3),  # two row tiles: 56 remainder tiles in halves
    ((5, 1400, 4096, 4096), (8, 32, 32, 1280, 132, 1), 10),  # batch 70: 9 rounds of 132, then 92 whole
    ((2, 20, 80, 200), (1, 2, 1, 4, 4, 1), 1),  # ragged N, K ends inside the one step
    ((1, 161, 272, 136), (1, 2, 3, 2, 2, 1), 1),
    ((2, 23, 64, 136), (1, 2, 1, 4, 4, 1), 1),
    ((1, 1, 16, 8), (1, 1, 1, 1, 1, 1), 1),
    ((5, 640, 64, 64), (4, 1, 1, 20, 20, 1), 1),  # the digits model's rows at batch 64 x 10 trials
]


@pytest.mark.parametrize("shape, want, waves", GEMM_PLANS, ids=[str(p[0]) for p in GEMM_PLANS])
def test_gemm_plan_is_a_function_of_the_shape(shape, want, waves):
    """The int8 GEMM's schedule is K1's persistent one at STEP_K bytes of K
    a step, on 192 x 128 tiles: the same shape, the same plan, with the
    waves and split noted in ``csrc/int8_gemm.cuh``."""
    p = k4.gemm_plan(*shape)
    assert tuple(p)[:6] == want and p.waves == waves
    assert p == k4.gemm_plan(*shape) == fl.wgmma_plan(*shape, step_k=k4.STEP_K)
    rem = p.tiles % p.grid
    assert p.work_bytes == (fl.FLAG_BYTES + 4 * rem * p.chunks * k4.TILE_ROWS * k4.TILE_COLS if p.chunks > 1 else 0)


def _walk(p):
    """{(tile, step): block} over every block's segments; fails on a step run twice."""
    seen = {}
    for b in range(p.grid):
        for tile, kb, ke, _ in fl.wgmma_segments(p, b):
            assert 0 <= kb < ke <= p.steps and 0 <= tile < p.tiles
            for ks in range(kb, ke):
                assert (tile, ks) not in seen, f"step {ks} of tile {tile} runs twice"
                seen[tile, ks] = b
    return seen


@pytest.mark.parametrize("k", range(16, 1040, 16))
def test_gemm_plan_runs_every_k_step_of_every_tile_once(k):
    """Whatever K (a multiple of 16), every (tile, K step) runs on exactly
    one block, and the steps' 128-byte TMA boxes cover K once (the last
    box's bytes past K arrive as zeros in both operands)."""
    p = k4.gemm_plan(5, 160, k, 256)
    assert _walk(p).keys() == {(t, ks) for t in range(p.tiles) for ks in range(p.steps)}
    assert p.steps == -(-k // k4.STEP_K) and (p.steps - 1) * k4.STEP_K < k <= p.steps * k4.STEP_K


@pytest.mark.parametrize("r", [1, 20, 63, 64, 65, 128, 160, 161, 192, 193, 1400])
def test_gemm_plan_rows_only_add_row_tiles(r):
    """R only adds 192-row tiles (columns and steps stay); within a tile
    the live 64-row slabs cover the rows below R and no slab wholly past
    R is loaded or multiplied."""
    p = k4.gemm_plan(5, r, 4096, 4096)
    assert p.row_tiles * k4.TILE_ROWS >= r > (p.row_tiles - 1) * k4.TILE_ROWS
    assert (p.col_tiles, p.steps, p.tiles) == (32, 32, 160 * p.row_tiles)
    covered = 0
    for t in range(p.row_tiles):
        _, row0, _ = fl.wgmma_tile(p, t)
        live = k4.live_slabs(r, row0)
        assert 1 <= live <= k4.SLABS
        assert row0 + 64 * (live - 1) < r <= row0 + 64 * live or live == k4.SLABS
        covered += min(64 * live, r - row0)
    assert covered == r


def test_gemm_plan_reads_each_weight_box_once_at_batch_8():
    """Batch 8 (R = 160): one row tile, so each (member, column strip, K
    step) box of the weight is loaded by one block once; 132 tiles run
    whole, the other 28 in quarters on 112 blocks, each quarter's partial
    int32 tile in the split workspace."""
    p = k4.gemm_plan(5, 160, 4096, 4096)
    loads = collections.Counter()
    for b in range(p.grid):
        for tile, kb, ke, _ in fl.wgmma_segments(p, b):
            mm, _, col0 = fl.wgmma_tile(p, tile)
            loads.update((mm, col0, ks) for ks in range(kb, ke))
    assert len(loads) == 5 * 32 * p.steps and set(loads.values()) == {1}
    lengths = sorted(sum(ke - kb for _, kb, ke, _ in fl.wgmma_segments(p, b)) for b in range(p.grid))
    assert lengths == [32] * 20 + [40] * 112
    assert p.busy == pytest.approx(160 / (132 * 1.25))


@pytest.mark.parametrize("offset", [0, 16, 1, 8])
def test_gemm_takes_16_byte_aligned_weights_and_refuses_others(offset):
    """The one body (TMA + s8 wgmma) takes every weight whose base is
    16-byte aligned (its tensor map); another base is refused before any
    launch, with no other body to fall back on."""
    m, k, n = 2, 64, 32
    storage = torch.zeros(offset + m * n * k + 16, dtype=torch.int8)
    base = storage.data_ptr() % 16
    w = storage[(16 - base) % 16 + offset:][:m * n * k].view(m, n, k).transpose(1, 2)
    assert w.stride() == (n * k, 1, k) and w.data_ptr() % 16 == offset % 16
    per_col = torch.zeros(m, n)
    assert k4.BODY == "wgmma"
    if offset % 16 == 0:
        assert k4.check_weight("k4", w, m, k, per_col) == n
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            k4.check_weight("k4", w, m, k, per_col)


def test_gemm_constants_match_the_kernel_source():
    """The plan's tile, box, step and workspace constants are the header's."""
    src = open(os.path.join(os.path.dirname(k4.__file__), "..", "csrc", "int8_gemm.cuh")).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert (64 * const("SLABS"), const("BN"), const("BK")) == (k4.TILE_ROWS, k4.TILE_COLS, k4.STEP_K)
    assert const("SLABS") == k4.SLABS and const("FLAG_BYTES") == fl.FLAG_BYTES
