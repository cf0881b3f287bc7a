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


from ladine_tpu_torch.kernels import int8_linear as k4  # noqa: E402


@pytest.mark.parametrize(
    "shape, want",
    [
        ((5, 160, 4096, 4096), (1, 32, (16, 16, 16, 16), 640)),  # the path at batch 8: 640 blocks
        ((5, 20, 4096, 4096), (1, 32, (16, 16, 16, 16), 640)),  # batch 1: one row tile, most slabs idle
        ((5, 161, 4096, 4096), (2, 32, (16, 16, 16, 16), 1280)),
        ((5, 1400, 4096, 4096), (9, 32, (16, 16, 16, 16), 5760)),  # batch 70
        ((2, 20, 80, 200), (1, 2, (1, 1, 0, 0), 16)),  # ragged N, K ends mid-step
        ((1, 161, 272, 136), (2, 2, (2, 1, 1, 1), 16)),
        ((2, 23, 64, 136), (1, 2, (1, 0, 0, 0), 16)),  # one step: three ranks add zeros
        ((1, 1, 16, 8), (1, 1, (1, 0, 0, 0), 4)),
    ],
)
def test_gemm_plan_is_a_function_of_the_shape(shape, want):
    assert tuple(k4.gemm_plan(*shape)) == want


@pytest.mark.parametrize("k", range(16, 1040, 16))
def test_gemm_plan_ranks_take_every_step_once(k):
    """Rank q sums the steps q, q + CLUSTER, ... of K: together every
    STEP_K-byte step once, whatever K (a multiple of 16)."""
    p = k4.gemm_plan(1, 1, k, 1)
    n_steps = -(-k // k4.STEP_K)
    assert len(p.steps) == k4.CLUSTER and sum(p.steps) == n_steps
    assert list(p.steps) == [len(range(q, n_steps, k4.CLUSTER)) for q in range(k4.CLUSTER)]


@pytest.mark.parametrize("r", [1, 20, 160, 161, 1400])
def test_gemm_plan_rows_only_add_row_tiles(r):
    p = k4.gemm_plan(5, r, 4096, 4096)
    assert p.row_tiles * k4.TILE_ROWS >= r > (p.row_tiles - 1) * k4.TILE_ROWS
    assert (p.col_tiles, p.steps) == (32, (16, 16, 16, 16)) and p.blocks == 640 * p.row_tiles
