"""The port's kernel wrappers against ladine_tpu's kernels on the CPU.

On the CPU each wrapper runs its plain version; the JAX functions run their
non-TPU branch, as tests/test_kernels.py runs them. Both sides compute in
float32 and differ only in summation order: rtol 1e-5 / atol 1e-6 for one
layer, 1e-4 / 1e-5 through the three-layer eps.

The kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import collections
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.kernels import flash_attention as jax_flash_attention
from ladine_tpu.kernels import fused_eps as jax_fused_eps
from ladine_tpu.kernels import fused_linear_act as jax_fused_linear_act
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu_torch.kernels import (
    flash_attention,
    flash_attention_plain,
    fused_eps,
    fused_linear_act,
    fused_linear_act_plain,
)
from ladine_tpu_torch.kernels import attention as attn_mod
from ladine_tpu_torch.kernels import fused_linear as fl_mod
from ladine_tpu_torch.models import ConditionalModel
from ladine_tpu_torch.utils import members_from_flax
from torch_inputs import layer_inputs, qkv_views
from torch_parity import j2t, jax_members, t2n


@pytest.mark.parametrize("shape", [(1, 9, 24, 17), (3, 20, 4, 40), (2, 33, 70, 65)])
@pytest.mark.parametrize("with_mult", [False, True])
def test_fused_linear_act_matches_jax(shape, with_mult):
    """Member-stacked (M, R, K) form, ragged R, K and N, against the JAX
    function applied member by member."""
    x, w, a, c, mult = layer_inputs(np.random.default_rng(0), *shape)
    out = fused_linear_act(j2t(x), j2t(w), j2t(a), j2t(c), j2t(mult) if with_mult else None)
    assert out.shape == shape[:2] + shape[3:] and out.dtype == torch.float32
    for i in range(shape[0]):
        ref = jax_fused_linear_act(jnp.asarray(x[i]), jnp.asarray(w[i]), jnp.asarray(a[i]),
                                   jnp.asarray(c[i]), jnp.asarray(mult[i]) if with_mult else None)
        np.testing.assert_allclose(t2n(out[i]), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_linear_act_plain_keeps_input_dtype():
    x, w, a, c, mult = layer_inputs(np.random.default_rng(1), 2, 5, 8, 6)
    out = fused_linear_act_plain(j2t(x).bfloat16(), j2t(w).bfloat16(), j2t(a), j2t(c))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(w=lambda w: w.double()), "must have x's dtype"),
        (dict(a=lambda a: a.double()), "a and c must be float32"),
        (dict(w=lambda w: w[:, :-1]), "disagree"),
        (dict(mult=lambda m: m[:, :-1]), "mult must be"),
        (dict(x=lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)), "contiguous"),
    ],
)
def test_fused_linear_act_rejects_what_the_kernel_cannot_take(bad, match):
    args = dict(zip("x w a c mult".split(), map(j2t, layer_inputs(np.random.default_rng(2), 2, 6, 8, 5))))
    for name, change in bad.items():
        args[name] = change(args[name])
    with pytest.raises((TypeError, ValueError), match=match):
        fl_mod._check(args["x"], args["w"], args["a"], args["c"], args["mult"])


def _eps_setup(members=3):
    jmodel = JaxConditionalModel(data_dim=48, feature_dim=16, hidden_dim=16, y_dim=2, n_steps=11)
    stacked = jax_members(jmodel, members, 48)
    model = ConditionalModel(members, 48, 16, 16, 2, 11, device="cpu")
    model.load_state_dict(members_from_flax(stacked))
    return jmodel, stacked, model


def _member(stacked, i):
    return jax.tree.map(lambda v: jnp.asarray(v[i]), stacked)


def test_fused_eps_matches_jax_fused_eps_and_flax_eps():
    jmodel, stacked, model = _eps_setup()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    y = rng.standard_normal((3, 5, 2)).astype(np.float32)
    yhat = rng.dirichlet([1, 1], size=(3, 5)).astype(np.float32)
    f_members = [np.asarray(jmodel.apply(_member(stacked, i), jnp.asarray(x), method="encode"))
                 for i in range(3)]
    f = j2t(np.stack(f_members))
    for t in (0, 5, 10):
        out = fused_eps(model, f, j2t(y), t, j2t(yhat))
        assert out.shape == (3, 5, 2)
        for i in range(3):
            v = _member(stacked, i)
            args = (jnp.asarray(f_members[i]), jnp.asarray(y[i]), jnp.asarray(t), jnp.asarray(yhat[i]))
            np.testing.assert_allclose(t2n(out[i]), np.asarray(jax_fused_eps(v, *args)),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(t2n(out[i]), np.asarray(jmodel.apply(v, *args, method="eps")),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda qkv: (qkv[:, :, 0].half(),) * 3, "float32 or bfloat16"),
        (lambda qkv: (qkv[:, :, 0], qkv[:, :, 1].contiguous(), qkv[:, :, 2]), "share strides"),
        (lambda qkv: (qkv[:, :, 0, :, :6],) * 3, "multiples of 16 bytes"),
        (lambda qkv: (qkv.flatten()[1:161].view(2, 5, 2, 8),) * 3, "multiples of 16 bytes"),
        (lambda qkv: (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :-1, 2]), "share one"),
    ],
    ids=["dtype", "strides", "ragged-D", "misaligned-pointer", "shape"],
)
def test_flash_attention_rejects_what_the_kernel_cannot_take(make, match):
    qkv, _ = qkv_views(np.random.default_rng(5), 2, 5, 2, 8)
    with pytest.raises((TypeError, ValueError), match=match):
        attn_mod._check(*make(qkv))
    b, n, h, d = attn_mod._check(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert (b, n, h, d) == (2, 5, 2, 8)


def test_flash_attention_matches_jax():
    qkv, (q, k, v) = qkv_views(np.random.default_rng(4), 2, 13, 4, 16)
    out = flash_attention(q, k, v)
    ref = jax_flash_attention(*(jnp.asarray(qkv[:, :, i].numpy()) for i in range(3)))
    assert out.shape == (2, 13, 4, 16)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "dtype, k, n, aligned, want",
    [
        (BF16, 4, 4096, True, ("small_k", True)),  # lin1 on the path
        (BF16, 4096, 4096, True, ("wgmma", True)),  # lin2 / lin3 on the path
        (F32, 4, 4096, True, ("small_k", True)),  # lin1 of the fp32 predictor
        (F32, 4096, 4096, True, ("tf32x3", True)),  # lin2 / lin3 of the fp32 predictor
        (BF16, 2, 4096, True, ("small_k", True)),
        (BF16, 16, 4096, True, ("small_k", True)),
        (BF16, 17, 4096, True, ("small_k", True)),  # K off 8: small_k up to SMALL_K = 32
        (F32, 16, 17, True, ("small_k", False)),  # N not a multiple of 8
        (BF16, 4096, 4096, False, ("mma", False)),  # a pointer off 16 bytes
        (BF16, 4, 4096, False, ("small_k", False)),
        (BF16, 24, 17, True, ("small_k", False)),
        (F32, 24, 17, True, ("small_k", False)),
        (BF16, 256, 200, True, ("wgmma", True)),
        (F32, 256, 200, True, ("simt", True)),  # float32 K <= SIMT_MAX_K stays on simt
        (BF16, 72, 64, True, ("wgmma", True)),
        (F32, 40, 12, True, ("simt", True)),  # fp32's vector is 4 wide
        (BF16, 20, 64, True, ("small_k", True)),  # lin1 at 10 classes (digits): K = 20
        (F32, 20, 64, True, ("small_k", True)),
        (BF16, 64, 64, True, ("wgmma", True)),  # digits lin2 / lin3
        (F32, 64, 64, True, ("simt", True)),  # the digits' (and the GMM check's) K: simt was faster
        # what stays on mma: K or N off the 16-byte vector, a pointer off 16 bytes
        (BF16, 4100, 4096, True, ("mma", False)),
        (BF16, 4096, 4100, True, ("mma", False)),
        (BF16, 24, 8, True, ("small_k", True)),
        (BF16, 24, 8, False, ("small_k", False)),
        (BF16, 64, 64, False, ("mma", False)),
        (BF16, 18, 4096, True, ("small_k", True)),  # lin1 at 9 classes
        # what stays on simt: float32 K or N off 4, a pointer off 16 bytes
        (F32, 4098, 4096, True, ("simt", False)),
        (F32, 4096, 4098, True, ("simt", False)),
        (F32, 4096, 4096, False, ("simt", False)),
        (F32, 18, 4096, True, ("small_k", True)),  # lin1 at 9 classes
        (F32, 20, 4096, False, ("small_k", False)),
        (F32, 16, 4096, True, ("small_k", True)),
        (F32, 17, 8, True, ("small_k", True)),
        (F32, 1024, 4096, True, ("simt", True)),  # SIMT_MAX_K
        (F32, 1028, 4096, True, ("tf32x3", True)),
        (F32, 1028, 4, True, ("tf32x3", True)),  # the smallest K and N tf32x3 takes
        (F32, 1028, 4096, False, ("simt", False)),
        # above SMALL_K = 32 (lin1 above 16 classes)
        (BF16, 40, 8, True, ("wgmma", True)),  # the smallest K a tensor map takes above small_k
        (BF16, 34, 4096, True, ("mma", False)),  # lin1 at 17 classes: K off 8
        (F32, 34, 4096, True, ("simt", False)),
        (F32, 36, 64, True, ("simt", True)),
        (BF16, 32, 4096, True, ("small_k", True)),  # lin1 at 16 classes
        (F32, 32, 4096, True, ("small_k", True)),
    ],
)
def test_fused_linear_act_plan_is_a_function_of_shape_dtype_and_alignment(dtype, k, n, aligned, want):
    assert fl_mod.plan(dtype, k, n, aligned) == want


@pytest.mark.parametrize("r", [1, 20, 160, 161, 1400])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fused_linear_act_plan_ignores_the_row_count(r, dtype):
    """Rows only add row tiles: lin2/lin3 take the GEMM body at any R, and
    lin1 the small_k body, through the wrapper's own check of the shapes."""
    x, w, a, c, mult = (torch.zeros(s, dtype=dtype if i in (0, 1, 4) else F32)
                        for i, s in enumerate([(5, r, 4096), (5, 4096, 8), (5, 8), (5, 8), (5, r, 8)]))
    m, r_, k, n = fl_mod._check(x, w, a, c, mult)
    assert (m, r_) == (5, r)
    assert fl_mod.plan(dtype, k, n, True) == ("wgmma" if dtype == BF16 else "tf32x3", True)
    assert fl_mod.plan(dtype, 4, n, True) == ("small_k", True)


# a gate of one row an image: (M, P, N) with P dividing R, row r = t P + i
# (trial t, image i) gated by row i = r % P


@pytest.mark.parametrize("gate_rows, ok", [(12, True), (6, True), (3, True), (1, True), (5, False), (7, False),
                                           (24, False), (0, False)])
def test_fused_linear_act_takes_a_gate_of_p_rows_dividing_r(gate_rows, ok):
    """``_check`` takes mult (M, P, N) where P divides R (P = R: a gate a
    row) and raises ValueError otherwise."""
    x, w, a, c, _ = (j2t(v) for v in layer_inputs(np.random.default_rng(40), 2, 12, 4, 8))
    mult = torch.zeros(2, gate_rows, 8)
    if ok:
        assert fl_mod._check(x, w, a, c, mult) == (2, 12, 4, 8)
    else:
        with pytest.raises(ValueError, match="mult must be"):
            fl_mod._check(x, w, a, c, mult)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("b, trials, k", [(3, 2, 4), (8, 20, 4), (1, 20, 4), (3, 4, 20), (5, 3, 2)])
def test_plain_per_image_gate_equals_the_repeated_gate_bit_for_bit(dtype, b, trials, k):
    """The plain version with the gate a row an image (M, B, N) gives the
    bits of the gate repeated over the trial-major rows (row t B + i takes
    image i: the engine's old ``f_rows``); under the map r // trials (the
    image-major order) it would not."""
    rng = np.random.default_rng(41)
    x, w, a, c, _ = (j2t(v) for v in layer_inputs(rng, 2, b * trials, k, 24))
    x, w = x.to(dtype), w.to(dtype)
    f = j2t(rng.standard_normal((2, b, 24)).astype(np.float32))
    rows = f.unsqueeze(1).expand(2, trials, b, 24).reshape(2, trials * b, 24).contiguous()
    got = fused_linear_act(x, w, a, c, f)
    assert torch.equal(got, fused_linear_act_plain(x, w, a, c, rows))
    assert torch.equal(got, fused_linear_act(x, w, a, c, rows))
    if b >= 3 and trials >= 2:
        wrong = f.repeat_interleave(trials, dim=1)  # row r gated by image r // trials
        assert not torch.equal(got, fused_linear_act_plain(x, w, a, c, wrong))


SMALL_K_SHAPES = [
    # (M, R, P, K, N): the path at batch 1, 8 and 70 (20 trials), the digits'
    # lin1 (K = 20, 64 images x 10 trials), K = 32, a gate a row, ragged N, one row
    (5, 20, 1, 4, 4096), (5, 160, 8, 4, 4096), (5, 1400, 70, 4, 4096), (5, 160, 8, 2, 4096),
    (5, 640, 64, 20, 64), (5, 160, 8, 32, 4096), (5, 160, 160, 4, 4096), (2, 9, 3, 16, 17),
    (1, 1, 1, 4, 8), (3, 4100, 4100, 4, 64), (1, 70, 7, 32, 4100),
]


@pytest.mark.parametrize("shape", SMALL_K_SHAPES, ids=str)
def test_small_k_plan_covers_every_output_once_within_the_sm_count(shape):
    """Every output (member, row, column) is written by exactly one row
    group's run; the grid is at most SK_BLOCKS_PER_SM blocks an SM (all
    resident at once) and every block has a unit; a unit's x rows and w's
    strip fit their shared memory."""
    m, r, gate_rows, k, n = shape
    p = fl_mod.small_k_plan(m, r, k, n)
    assert p == fl_mod.small_k_plan(m, r, k, n)
    assert 1 <= p.grid <= fl_mod.SMS * fl_mod.SK_BLOCKS_PER_SM and p.grid <= p.units
    assert p.tx * p.groups == fl_mod.SK_THREADS and p.units == m * p.strips * p.splits
    assert -(-r // p.splits) * k <= fl_mod.SK_X_FLOATS
    assert k <= fl_mod.SK_REG_K or k * fl_mod.SK_VEC * p.tx <= fl_mod.SK_W_FLOATS
    assert p.smem_bytes <= 48 * 1024  # no opt-in past the default dynamic shared memory
    cover = np.zeros((m, r, n), dtype=int)
    blocks = set()
    for block, member, rows, col0, col1 in fl_mod.small_k_runs(p, r, gate_rows, n):
        blocks.add(block)
        assert col0 < col1 <= n
        cover[member, rows, col0:col1] += 1
    assert (cover == 1).all()
    assert blocks == set(range(p.grid))


@pytest.mark.parametrize("r, gate_rows", [(20, 1), (160, 8), (1400, 70)])
def test_small_k_plan_fills_the_card_and_reads_each_gate_row_once_a_group(r, gate_rows):
    """At the path's R = 20, 160 and 1400 (batch 1, 8, 70 at 20 trials) every
    SM takes a block of 4 warps, and each row group walks its rows image by
    image: it loads an image's gate row once and reuses it over the trials."""
    p = fl_mod.small_k_plan(5, r, 4, 4096)
    assert p.grid >= fl_mod.SMS and (p.tx, p.groups) == (64, 2)
    for _, _, rows, _, _ in fl_mod.small_k_runs(p, r, gate_rows, 4096):
        images = [row % gate_rows for row in rows]
        assert images == sorted(images)  # a change of image never comes back
    loads = sum(len({row % gate_rows for row in rows}) for _, _, rows, _, _ in fl_mod.small_k_runs(p, r, gate_rows, 4096))
    assert loads <= 2 * 5 * p.strips * max(gate_rows, p.splits * p.groups)


@pytest.mark.parametrize("k", [4, 20, 34])
def test_fused_eps_takes_the_features_a_row_an_image(k, monkeypatch):
    """fused_eps with the features a row an image (M, B, F) gives the bits
    of the features repeated over the trial-major rows; lin1 gets them as
    they are where small_k takes its K, and repeated to R rows past it (the
    GEMM bodies read a gate a row)."""
    fe_mod = importlib.import_module("ladine_tpu_torch.kernels.fused_eps")
    c = k // 2
    model = ConditionalModel(2, 12, 16, 16, c, 7, device="cpu")
    rng = np.random.default_rng(42)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32)) * 0.3)
        for name, buf in model.named_buffers():  # the constructor leaves them unset (torch.empty)
            if "running_mean" in name:
                buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape).astype(np.float32)) * 0.1)
            elif "running_var" in name:
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    b, trials = 3, 2
    f = j2t(rng.standard_normal((2, b, 16)).astype(np.float32))
    f_rows = f.unsqueeze(1).expand(2, trials, b, 16).reshape(2, trials * b, 16).contiguous()
    y = j2t(rng.standard_normal((2, trials * b, c)).astype(np.float32))
    y_hat = j2t(rng.dirichlet([1] * c, size=(2, trials * b)).astype(np.float32))
    gates = []
    real = fe_mod.fused_linear_act
    monkeypatch.setattr(fe_mod, "fused_linear_act", lambda *a, mult=None: (gates.append(mult), real(*a, mult=mult))[1])
    got = fused_eps(model, f, y, 3, y_hat)
    assert torch.isfinite(got).all()
    assert torch.equal(got,fused_eps(model, f_rows, y, 3, y_hat))
    assert gates[0].shape == ((2, b, 16) if k <= fl_mod.SMALL_K else (2, trials * b, 16))
    assert torch.equal(gates[0], f if k <= fl_mod.SMALL_K else f_rows)


WGMMA_SHAPES = [(5, r, 4096, 4096) for r in (1, 20, 160, 161, 1400)] + [(5, 640, 64, 64)]
# (waves, chunks of a remainder tile) as the note of csrc/fused_linear.cu gives them
WGMMA_WAVES = {1: (2, 4), 20: (2, 4), 160: (2, 4), 161: (2, 4), 1400: (10, 1), 640: (1, 1)}


def _wgmma_walk(p):
    """{(tile, step): block} over every block's segments; fails on a step run twice."""
    seen = {}
    for b in range(p.grid):
        for tile, kb, ke, _ in fl_mod.wgmma_segments(p, b):
            assert 0 <= kb < ke <= p.steps and 0 <= tile < p.tiles
            for ks in range(kb, ke):
                assert (tile, ks) not in seen, f"step {ks} of tile {tile} runs twice"
                seen[tile, ks] = b
    return seen


@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=str)
def test_wgmma_plan_covers_every_output_tile_once(shape):
    """Every (tile, K-step) of the product runs on exactly one block, and
    the tiles cover the output: each element in exactly one tile."""
    m, r, k, n = shape
    p = fl_mod.wgmma_plan(m, r, k, n)
    assert _wgmma_walk(p).keys() == {(t, ks) for t in range(p.tiles) for ks in range(p.steps)}
    assert p.steps == -(-k // fl_mod.STEP_K)
    cover = np.zeros((m, r, n), dtype=int)
    for t in range(p.tiles):
        mm, row0, col0 = fl_mod.wgmma_tile(p, t)
        assert row0 < r and col0 < n
        cover[mm, row0:row0 + fl_mod.TILE_ROWS, col0:col0 + fl_mod.TILE_COLS] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=str)
def test_wgmma_plan_splits_only_the_remainder_tiles_in_equal_chunks(shape):
    """Tiles of the whole rounds run on one block each, every block of a
    round on its own tile from K step 0; each remainder tile runs in
    ``chunks`` chunks of equal depth (within a step), chunk q on block
    q * rem + j, which knows the tile's remainder index. The workspace holds
    a count per split tile and a partial tile per block that runs a chunk."""
    p = fl_mod.wgmma_plan(*shape)
    seen = _wgmma_walk(p)
    rounds, rem = divmod(p.tiles, p.grid)
    for t in range(rounds * p.grid):
        assert {seen[t, ks] for ks in range(p.steps)} == {t % p.grid}
    for j in range(rem):
        t = rounds * p.grid + j
        blocks = [seen[t, ks] for ks in range(p.steps)]
        assert sorted(set(blocks)) == [q * rem + j for q in range(p.chunks)]
        depths = collections.Counter(blocks).values()
        assert max(depths) - min(depths) <= 1
        for q in range(p.chunks):
            assert list(fl_mod.wgmma_segments(p, q * rem + j))[-1][3] == (j if p.chunks > 1 else -1)
    assert (p.work_bytes > 0) == (rem > 0 and p.chunks > 1)
    if p.work_bytes:
        assert p.work_bytes == fl_mod.FLAG_BYTES + 4 * rem * p.chunks * fl_mod.PART_FLOATS
        assert rem * 4 <= fl_mod.FLAG_BYTES and rem * p.chunks <= p.grid


@pytest.mark.parametrize("r", [1, 20, 160, 161, 192])
def test_wgmma_plan_reads_each_weight_strip_once_when_r_fits_a_row_tile(r):
    """R <= TILE_ROWS: one row tile, so each (member, column tile, K-step)
    box of the weights is loaded by one block once; all 132 SMs take a block,
    and the remainder's chunks fill 112 of them for a quarter of K."""
    p = fl_mod.wgmma_plan(5, r, 4096, 4096)
    assert p.row_tiles == 1 and p.grid == fl_mod.SMS and p.chunks == 4
    loads = collections.Counter()
    for b in range(p.grid):
        for tile, kb, ke, _ in fl_mod.wgmma_segments(p, b):
            mm, _, col0 = fl_mod.wgmma_tile(p, tile)
            loads.update((mm, col0, ks) for ks in range(kb, ke))
    assert len(loads) == 5 * (4096 // fl_mod.TILE_COLS) * p.steps and set(loads.values()) == {1}
    lengths = sorted(sum(ke - kb for _, kb, ke, _ in fl_mod.wgmma_segments(p, b)) for b in range(p.grid))
    assert lengths == [64] * 20 + [80] * 112


@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=str)
def test_wgmma_plan_is_a_function_of_the_shape_with_the_noted_waves(shape):
    """Same shape, same plan (the split boundaries follow from it alone);
    the waves, chunks and busy share are those of the source note."""
    m, r, k, n = shape
    p = fl_mod.wgmma_plan(*shape)
    assert p == fl_mod.wgmma_plan(*shape)
    assert [list(fl_mod.wgmma_segments(p, b)) for b in range(p.grid)] == \
        [list(fl_mod.wgmma_segments(fl_mod.wgmma_plan(*shape), b)) for b in range(p.grid)]
    assert (p.waves, p.chunks) == WGMMA_WAVES[r]
    assert p.grid == min(fl_mod.SMS, p.tiles)
    longest = max(sum(ke - kb for _, kb, ke, _ in fl_mod.wgmma_segments(p, b)) for b in range(p.grid))
    assert p.busy == pytest.approx(p.tiles * p.steps / (p.grid * longest))
    if r == 1400:  # 1280 tiles: 9 waves of 132 and one of 92
        assert p.tiles == 1280 and p.busy == pytest.approx(1280 / 1320)
    if r == 160:  # 160 tiles: 132 whole, 28 in quarters on 112 blocks
        assert p.busy == pytest.approx(160 / (132 * 1.25))


TF32X3_SHAPES = [(5, r, 4096, 4096) for r in (1, 20, 160, 161, 1400)] + [(5, 640, 1028, 68), (2, 33, 2048, 4)]


@pytest.mark.parametrize("shape", TF32X3_SHAPES, ids=str)
def test_tf32x3_plan_covers_every_output_tile_once_and_fits_a_block(shape):
    """The tf32x3 body runs the wgmma body's tiles and schedule at 128
    bytes of float32 K a step: every (tile, K-step) on exactly one block,
    each output element in exactly one tile, at most SMS blocks, split
    tiles only in the remainder round; its rings (3 stages of x's slabs with
    w's two TF32 halves, 2 of w as loaded) and x_lo fit the shared memory
    of a block."""
    m, r, k, n = shape
    p = fl_mod.wgmma_plan(m, r, k, n, fl_mod.TF32_STEP_K)
    assert fl_mod.plan(F32, k, n, True) == ("tf32x3", True)
    assert p.steps == -(-k // 32) and p.grid == min(fl_mod.SMS, p.tiles)
    assert _wgmma_walk(p).keys() == {(t, ks) for t in range(p.tiles) for ks in range(p.steps)}
    cover = np.zeros((m, r, n), dtype=int)
    for t in range(p.tiles):
        mm, row0, col0 = fl_mod.wgmma_tile(p, t)
        cover[mm, row0:row0 + fl_mod.TILE_ROWS, col0:col0 + fl_mod.TILE_COLS] += 1
    assert (cover == 1).all()
    rounds, rem = divmod(p.tiles, p.grid)
    assert (p.work_bytes > 0) == (rem > 0 and p.chunks > 1)
    if r <= fl_mod.TILE_ROWS and k == 4096:  # one row tile: 132 whole tiles, the other 28 in K quarters
        assert (p.grid, p.chunks, p.waves) == (132, 4, 2)
    if r == 1400:  # 1280 tiles: 9 waves of 132 and one of 92, none split
        assert (p.tiles, p.waves, p.chunks, p.work_bytes) == (1280, 10, 1, 0)
    slabs, w = 4 * 32 * 3 * 64, 4 * 32 * 128  # x's three slabs (or x_lo's) and w (or w_hi, or w_lo) a stage
    assert fl_mod.TF32X3_SMEM_BYTES == 128 + 1024 + 3 * (slabs + 2 * w) + 2 * w + slabs == 230528
    assert fl_mod.TF32X3_SMEM_BYTES <= fl_mod.SMEM_LIMIT


def _tf32(t, ties):
    """t rounded to TF32 (10 mantissa bits) as float32, to nearest: ties
    away from zero (``cvt.rna.tf32.f32``, and the kernel's integer rounding)
    or to even."""
    bits = t.contiguous().view(torch.int32)
    half = 0x1000 if ties == "away" else 0xFFF + ((bits >> 13) & 1)
    return ((bits + half) & -8192).view(torch.float32)


def _trunc(t):
    """t's top 19 bits: what a TF32 product on the tensor cores reads of a float32 value."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


@pytest.mark.parametrize("ties", ["away", "even"])
def test_tf32x3_split_holds_the_float32_tolerance_where_one_tf32_pass_does_not(ties):
    """The tf32x3 body's arithmetic, emulated: each of x and w split as
    hi = trunc(v) (its top 19 bits) and lo = v - hi rounded to TF32
    (``hopper::tf32_lo``), the product taken as x_hi w_hi + x_hi w_lo +
    x_lo w_hi in float32, then K1's epilogue. At the path's lin2/lin3 shape
    (5, 160, 4096) x (5, 4096, 4096) it is within K1's float32 tolerance
    (1e-4 abs + 1e-4 rel) of a float64 reference; one TF32 pass on inputs
    rounded to nearest (x_tf32 w_tf32) misses it, which is why the body
    splits."""
    rng = np.random.default_rng(29)
    excess3 = excess1 = -1.0
    for _ in range(5):  # member by member: one member's float64 weight is 128 MiB
        x, w, a, c, _m = (torch.from_numpy(v[0]) for v in layer_inputs(rng, 1, 160, 4096, 4096))
        ref = torch.nn.functional.softplus((x.double() @ w.double()) * a.double() + c.double())
        xh, wh = _trunc(x), _trunc(w)
        xl, wl = _tf32(x - xh, ties), _tf32(w - wh, ties)
        for z, name in ((xl @ wh + xh @ wl + xh @ wh, "3"), (_tf32(x, ties) @ _tf32(w, ties), "1")):
            out = torch.nn.functional.softplus(z * a + c).double()
            excess = ((out - ref).abs() - 1e-4 * (1 + ref.abs())).max().item()
            if name == "3":
                excess3 = max(excess3, excess)
            else:
                excess1 = max(excess1, excess)
    assert excess3 <= 0.0, excess3
    assert excess1 > 0.0, excess1


@pytest.mark.parametrize("k", [4, 16, 18, 20, 64, 4096])
def test_fused_linear_act_takes_a_float32_gate_beside_bf16_at_any_k(k):
    """F6: lin1's gate is the float32 features beside bf16 y_in and w1, at
    K = 2C for any class count, as the JAX ``_kernel_mult`` takes it; the
    plan is the same as without a gate. Only a gate of a third dtype, or a
    bf16 gate beside float32 x, is refused."""
    x, w, mult = torch.zeros(2, 3, k, dtype=BF16), torch.zeros(2, k, 8, dtype=BF16), torch.zeros(2, 3, 8)
    a = c = torch.zeros(2, 8)
    assert fl_mod._check(x, w, a, c, mult) == (2, 3, k, 8)
    want = ("small_k", True) if k <= fl_mod.SMALL_K else ("wgmma", True) if k % 8 == 0 else ("mma", False)
    assert fl_mod.plan(BF16, k, 8, True) == want
    with pytest.raises(TypeError, match="mult must be float32 or x's dtype"):
        fl_mod._check(x, w, a, c, mult.half())
    with pytest.raises(TypeError, match="mult must be float32 or x's dtype"):
        fl_mod._check(x.float(), w.float(), a, c, mult.bfloat16())
    out = fused_linear_act(x, w, a, c, mult)  # the plain version on the CPU: one rounding, in x's dtype
    assert out.dtype == BF16 and out.shape == (2, 3, 8)


# K3's launch geometry: attention_plan's route, grid and shared memory, and
# the layout the wrapper reads off the views (pure functions, no card).
ROUTE_CASES = [
    # bfloat16 at D = 64 and N <= 256 with a TMA layout: the wgmma body
    *[(BF16, n, 64, 16, True, "wgmma", 64) for n in (1, 64, 65, 196, 197, 198, 256)],
    # bfloat16 past 256 keys, off D = 64, or off TMA's strides: the mma body
    *[(BF16, n, 64, 16, True, "mma", 64) for n in (257, 300)],
    *[(BF16, 196, d, 16, True, "wgmma", 64) for d in (8, 16, 24, 32, 40, 48)],  # 64-column boxes, zeros past D
    *[(BF16, 196, d, 16, True, "mma", d) for d in (80, 128)],
    *[(BF16, 197, d, vec, False, "mma", dp) for d, vec, dp in ((8, 8, 16), (12, 8, 16), (24, 16, 32), (40, 16, 48),
                                                               (100, 8, 112), (2, 4, 16))],
    (BF16, 197, 64, 8, True, "mma", 64),
    (BF16, 197, 64, 16, False, "mma", 64),
    # float32 of any D of whole 16-byte vectors: the simt body
    *[(F32, n, d, 16, True, "simt", d) for n, d in ((197, 4), (197, 8), (197, 24), (197, 64), (197, 100),
                                                    (16, 12), (198, 12), (197, 48), (300, 12))],
]


@pytest.mark.parametrize("dtype, n, d, vec, tma, route, dp", ROUTE_CASES)
def test_attention_plan_routes_each_dtype_n_and_d(dtype, n, d, vec, tma, route, dp):
    p = attn_mod.attention_plan(8, n, 12, d, dtype, vec, tma)
    assert (p.route, p.dp) == (route, dp)
    assert p.q_tiles == -(-n // p.rows) and p.rows == (128 if route == "simt" and 8 * 12 * -(-n // 128) >= 264 else 64)
    if route == "wgmma":
        assert p.keys == -(-n // 16) * 16 and p.threads == 384 and p.vb == 16
    elif route == "mma":  # the widest copy that divides D's bytes and the strides
        assert p.keys == -(-n // 32) * 32 and p.vb == min(vec, (2 * d) & -(2 * d)) and (2 * d) % p.vb == 0
    else:
        assert p.keys == n and p.threads == 4 * p.rows


@pytest.mark.parametrize(
    "dtype, n, d, vec, error, match",
    [
        (BF16, 196, 136, 16, ValueError, "even D up to 128"),
        (BF16, 196, 144, 16, ValueError, "even D up to 128"),
        (BF16, 196, 7, 16, ValueError, "even D up to 128"),
        (BF16, 196, 64, 2, ValueError, "4-byte aligned"),
        (F32, 196, 6, 16, ValueError, "multiples of 16 bytes"),
        (F32, 196, 64, 8, ValueError, "multiples of 16 bytes"),
        (F32, 2000, 64, 16, ValueError, "do not fit in shared memory"),
        (F32, 400, 64, 16, ValueError, "do not fit in shared memory"),
        (BF16, 2000, 128, 16, ValueError, "do not fit in shared memory"),
        (torch.float16, 196, 64, 16, TypeError, "float32 or bfloat16"),
    ],
)
def test_attention_plan_raises_on_what_no_body_takes(dtype, n, d, vec, error, match):
    with pytest.raises(error, match=match):
        attn_mod.attention_plan(2, n, 3, d, dtype, vec)


def _plan_tiles(p, b, h):
    """Every (b, h, query tile) the plan's blocks run, in launch order."""
    if p.route != "wgmma":  # one block a (tile, h, b)
        return [(bb, hh, t) for bb in range(b) for hh in range(h) for t in range(p.q_tiles)]
    seen = []
    for block in range(p.grid):
        for u in range(block, p.units, p.grid):
            pair, split = divmod(u, p.splits)
            for i in range(p.tpu):
                if split * p.tpu + i < p.q_tiles:
                    seen.append((pair // h, pair % h, split * p.tpu + i))
    return seen


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("b, n, h, d", [(8, 196, 12, 64), (8, 197, 12, 64), (70, 197, 12, 64), (70, 196, 12, 64),
                                        (30, 198, 12, 64), (30, 197, 16, 48), (64, 17, 4, 12), (1, 1, 1, 64),
                                        (3, 65, 2, 64), (2, 256, 3, 64), (2, 300, 3, 64)])
def test_attention_plan_grid_covers_every_tile_once(dtype, b, n, h, d):
    p = attn_mod.attention_plan(b, n, h, d, dtype)
    tiles = _plan_tiles(p, b, h)
    assert sorted(tiles) == [(bb, hh, t) for bb in range(b) for hh in range(h) for t in range(-(-n // p.rows))]
    if p.route == "wgmma":
        assert p.grid == min(attn_mod.SMS, p.units) and p.units == b * h * p.splits
        assert (p.splits - 1) * p.tpu < p.q_tiles <= p.splits * p.tpu  # no unit is empty
    else:
        assert p.grid == p.units == p.q_tiles * h * b


@pytest.mark.parametrize("b, n, splits, tpu, units, rounds", [
    (8, 196, 2, 2, 192, 2),    # 96 pairs: query tiles split across blocks to fill the 132 SMs
    (8, 197, 2, 2, 192, 2),
    (70, 197, 2, 2, 1680, 13),  # 840 pairs: 13 tile rounds, where whole pairs take 14
    (30, 197, 1, 4, 360, 6),   # 360 pairs: splitting gains no round
])
def test_attention_plan_fills_the_card_at_batch_8_and_70(b, n, splits, tpu, units, rounds):
    p = attn_mod.attention_plan(b, n, 12, 64, BF16)
    assert (p.route, p.splits, p.tpu, p.units, p.grid, p.rounds) == ("wgmma", splits, tpu, units, 132, rounds)


@pytest.mark.parametrize("dtype, b, n, h, d", [
    (BF16, 8, 196, 12, 64), (BF16, 70, 197, 12, 64), (BF16, 30, 198, 12, 64), (BF16, 2, 256, 3, 64),
    (BF16, 2, 300, 3, 64), (BF16, 64, 17, 4, 12), (F32, 70, 197, 12, 64), (F32, 30, 198, 12, 64),
    (F32, 30, 197, 16, 48), (F32, 64, 17, 4, 12), (F32, 2, 256, 3, 64), (F32, 2, 300, 3, 64),
    (F32, 2, 375, 3, 64), (F32, 2, 197, 3, 132), (F32, 70, 375, 12, 64),
])
def test_attention_plan_shared_memory_fits_a_block(dtype, b, n, h, d):
    """A block's shared memory, as each body lays it out, within 227 KB."""
    p = attn_mod.attention_plan(b, n, h, d, dtype)
    if p.route == "wgmma":  # barriers, 1024-byte alignment, 2 stages of K, V and the unit's Q tiles
        want = 128 + 1024 + 2 * (2 * p.keys * 128 + p.tpu * 64 * 128)
    elif p.route == "mma":  # K and V padded to 32 keys, the Q tile, rows of dp + 8
        want = (2 * -(-n // 32) * 32 + 64) * (p.dp + 8) * 2
    else:  # K, V (unless late), the Q tile at an odd number of vectors a row, the transposed scores
        ld, rows = d + (4 if (d // 4) % 2 == 0 else 0), p.rows
        want = (((1 if p.late_v else 2) * n + rows) * ld + n * (rows + 4)) * 4
        assert p.late_v == (((2 * n + rows) * ld + n * (rows + 4)) * 4 > 232448)
    assert p.smem_bytes == want <= 232448


@pytest.mark.parametrize("d, route, dp", [(8, "wgmma", 64), (12, "mma", 16), (16, "wgmma", 64), (24, "wgmma", 64),
                                          (40, "wgmma", 64), (100, "mma", 112), (128, "mma", 128)])
def test_bf16_heads_of_any_even_width_are_padded_in_the_kernel(d, route, dp):
    """F7 without copies: a bfloat16 head of width D is read at its real
    width from the strided views and padded with zeros inside the kernel,
    to 64 columns by the wgmma body's TMA boxes (D a multiple of 8 whose
    strides are 16-byte multiples) or to a multiple of 16 in the mma body's
    shared memory (the digits' D = 12: 24-byte rows), with D's scale. Zero
    columns add nothing to q k^T and give zero output columns: the plain
    attention of zero-padded heads, sliced, is that of the real heads."""
    qkv, (q, k, v) = qkv_views(np.random.default_rng(6), 2, 17, 4, d)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert attn_mod._check(qb, kb, vb) == (2, 17, 4, d)
    _, vec, tma = attn_mod._layout(qb, kb, vb)
    p = attn_mod.attention_plan(2, 17, 4, d, BF16, vec, tma)
    assert (p.route, p.dp) == (route, dp) and (2 * d) % p.vb == 0
    pad = [torch.nn.functional.pad(t, (0, dp - d)) for t in (qb, kb, vb)]
    s = torch.einsum("bnhd,bmhd->bhnm", pad[0].float(), pad[1].float()) * d**-0.5
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1).to(BF16), pad[2]).to(BF16)[..., :d]
    torch.testing.assert_close(out, flash_attention_plain(qb, kb, vb), rtol=0, atol=0)


@pytest.mark.parametrize("b, n, h, d, dtype, view, vec, tma", [
    (8, 197, 12, 64, BF16, "qkv", 16, True),   # the ViT's fused projection
    (64, 17, 4, 12, BF16, "qkv", 8, False),    # the digits ViT: 24-byte heads
    (2, 5, 3, 64, BF16, "contiguous", 16, True),
    (2, 5, 3, 64, BF16, "heads-major", 16, False),  # (B, H, N, D) transposed: H outside N
    (1, 1, 1, 64, BF16, "qkv", 16, True),
    (8, 197, 12, 64, F32, "qkv", 16, True),
])
def test_attention_layout_reads_vector_width_and_tma_off_the_views(b, n, h, d, dtype, view, vec, tma):
    if view == "qkv":
        x = torch.zeros(b, n, 3, h, d, dtype=dtype)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    elif view == "contiguous":
        q = k = v = torch.zeros(b, n, h, d, dtype=dtype)
    else:
        q = k = v = torch.zeros(b, h, n, d, dtype=dtype).transpose(1, 2)
    strides, got_vec, got_tma = attn_mod._layout(q, k, v)
    assert (got_vec, got_tma) == (vec, tma)
    assert strides[2] >= d or h == 1


@pytest.mark.parametrize("m, r, n, c, flags, total", [
    (5, 160, 4096, 2, 32, 32 + 4 * 5 * 32 * 160 * 2),      # full width at batch 8: 32 column tiles
    (5, 1400, 4096, 2, 160, 160 + 4 * 5 * 32 * 1400 * 2),  # batch 70: 8 row tiles
    (5, 640, 64, 10, 80, 80 + 4 * 5 * 1 * 640 * 10),       # the digits model: one column tile
    (1, 1, 16, 1, 16, 16 + 4 * 1 * 1 * 1 * 1),
    (2, 161, 129, 3, 16, 16 + 4 * 2 * 2 * 161 * 3),
])
def test_k5b_workspace_is_a_function_of_the_shape(m, r, n, c, flags, total):
    """D5: K5b's column tiles leave their lin4 sums in a workspace, a count
    a (member, row tile) then an (R, C) float32 slot a (member, column
    tile) of lin3's GEMM plan, and the last block sums the slots in order."""
    from ladine_tpu_torch.kernels.int8_eps_fused import l34_workspace_bytes
    from ladine_tpu_torch.kernels.int8_linear import gemm_plan

    p = gemm_plan(m, r, 4096, n)
    assert l34_workspace_bytes(m, r, n, c) == (flags, total)
    assert flags % 16 == 0 and flags >= 4 * m * p.row_tiles
    assert total - flags == 4 * m * p.col_tiles * r * c


def test_float_predictor_with_the_per_image_gate_matches_jax():
    """The float chain passes lin1 the features a row an image: at B = 3
    images and 2 trials (distinct gate rows, trial-major rows) the port's
    ``Predictor.predict`` equals the JAX package's on the same weights and
    injected draws (DDIM-5 at eta 1), float32 on both sides: probs, PIW and
    variance within rtol 1e-4 / atol 1e-5 (summation order along the
    chain, as tests/test_torch_serve.py), the votes equal."""
    from ladine_tpu.infer import Predictor as JaxPredictor
    from ladine_tpu.models import SEViTGuidance as JaxGuidance
    from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
    from ladine_tpu_torch.infer import Predictor
    from ladine_tpu_torch.models import SEViTGuidance
    from ladine_tpu_torch.ops import DiffusionSchedule
    from ladine_tpu_torch.utils import guidance_from_flax
    from torch_parity import jax_ensemble_noise

    g_kw = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16, num_heads=2,
                mlp_hidden_dims=(16, 8, 8))
    steps, b, trials = 10, 3, 2
    jg = JaxGuidance(**g_kw)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))))
    jm = JaxConditionalModel(data_dim=768, feature_dim=8, hidden_dim=8, y_dim=2, n_steps=steps + 1)
    stacked = jax_members(jm, 3, 768)
    guidance = SEViTGuidance(**g_kw, device="cpu")
    guidance.load_state_dict(guidance_from_flax(gvars))
    model = ConditionalModel(3, 768, 8, 8, 2, steps + 1, device="cpu")
    model.load_state_dict(members_from_flax(stacked))
    kw = dict(temperature=0.2, mc_trials=trials, ddim_steps=5, ddim_eta=1.0)
    ref = JaxPredictor(guidance=jg, guidance_vars=gvars, model=jm, stacked_vars=stacked,
                       sched=JaxSchedule.create("linear", steps, 1e-4, 0.02), **kw)
    ours = Predictor(guidance=guidance, model=model, sched=DiffusionSchedule.create("linear", steps, 1e-4, 0.02,
                                                                                      device="cpu"),
                     device="cpu", **kw)
    images = np.random.default_rng(43).random((b, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(44)
    noise = jax_ensemble_noise(key, 3, trials, (b, 2), len(ours._tau))
    want = ref.predict(images, key=key)
    got = ours.predict(images, noise=j2t(noise))
    np.testing.assert_array_equal(got["majority_vote"], np.asarray(want["majority_vote"]))
    for name in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=1e-4, atol=1e-5, err_msg=name)
