"""The port's mesh (``ladine_tpu_torch/parallel/``) and its sharded train
steps, on four ``gloo`` ranks on the CPU (``tests/torch_mesh.py``; all the
multi-rank cases of this file run in one spawned group).

* The pure-Python parts against ``ladine_tpu.parallel``: ``factor_mesh``,
  ``multislice_factor``, the grouping of ranks by slice (the JAX one on
  the conftest's 8 virtual devices), ``describe_mesh``'s lines and
  ``fsdp_plan``'s leaf choice against ``fsdp_shardings``.
* Each step of ``tests/torch_mesh.py::TRAIN_CASES`` (multi-member, full
  and joint; (2, 2) and (1, 4) meshes, the latter with 5 members so that
  data != member and a wrong loss scale shows; FSDP on (1, 4) and (2, 2),
  and with ``lowmem``) against the port's one-process step from the same
  seeds, float32: losses to rel 1e-5, new parameters to abs 2.1e-3 (Adam's
  first step is ~lr * sign(g), and the order of the sums over 'data' can
  flip the sign of a near-zero gradient, as ``tests/test_sharding.py``
  holds JAX's), first moments to 2e-5 of their leaf's largest (the nominal
  1e-5 is exceeded by one BatchNorm scale of multi_2x2 at 1.03e-5, an
  absolute 3.1e-9: its gradient is a batch sum that cancels, and the
  shards sum in another order), running statistics to rel 1e-5, the EMA
  to the parameters' bar times (1 - mu), the counts and the generator's
  next draw equal (every rank draws the
  whole t, noise and rounding bits and keeps its slice). The biases before
  a train-mode BatchNorm have an exact-zero gradient (rounding noise on
  both sides) and are left out of the moment check. With ``lowmem`` the
  bfloat16 moments and EMA round with the bits one process draws (chunks
  of ``SMALL_CHUNK`` whose edges fall inside the shards): an element may
  differ where the float32 value it rounds moved across a rounding edge,
  at most 1 % of a leaf (0.22 % measured, in enc_lin1's small gradients;
  independent bits would put half of every leaf a step apart), and by the
  float32 bar plus one bfloat16 step of its value.
* The port's full step on a (2, 2) mesh against ``ladine_tpu``'s on a
  (2, 2) mesh of virtual devices from one JAX state and the same draws,
  with ``tests/test_sharding.py``'s bars (the counterpart of
  ``__graft_entry__.py``'s ``dryrun_multichip``). ``make_mesh(4,
  num_members=4)`` is (4, 1) in both packages (``factor_mesh``), so the
  (2, 2) meshes are built from explicit rank and device arrays.
* A checkpoint written on (2, 2) (rank 0 writes, once) read in one process,
  and one written in one process read on (2, 2), with FSDP leaves: equal.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_mesh as TM
from ladine_tpu.models import ConditionalModel as JaxModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu.parallel import describe_mesh as jax_describe_mesh
from ladine_tpu.parallel import factor_mesh as jax_factor_mesh
from ladine_tpu.parallel import fsdp_shardings
from ladine_tpu.parallel import group_devices_by_slice as jax_group_devices_by_slice
from ladine_tpu.parallel import make_mesh as jax_make_mesh
from ladine_tpu.parallel import multislice_factor as jax_multislice_factor
from ladine_tpu.train import create_member_states as jax_create_member_states
from ladine_tpu.train import make_full_train_step as jax_make_full_train_step
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer
from ladine_tpu_torch.parallel import factor_mesh, group_devices_by_slice, multislice_factor
from ladine_tpu_torch.utils import guidance_from_flax, load_train_state, member_state_from_jax, save_train_state
from torch_parity import jax_multi_draws, one_torch_thread, t2n  # noqa: F401 (autouse)

PRE_BN = ("enc_lin1.bias", "enc_lin2.bias", "enc_lin3.bias")  # exact-zero gradients
JAX_GUIDANCE = dict(num_classes=2, num_members=4, vit_depth=5, img_size=TM.IMG, patch_size=8, embed_dim=32,
                    num_heads=2, mlp_hidden_dims=(32, 16, 8))
FSDP_MIN = 64
EMA_ATOL = 2.1e-3 * (1 - 0.9999)  # the parameters' bar, carried into the EMA by (1 - mu)


def jax_model():
    return JaxModel(data_dim=TM.DATA_DIM, feature_dim=TM.FEATURE, hidden_dim=TM.FEATURE, y_dim=2,
                    n_steps=TM.T_STEPS + 1)


@pytest.fixture(scope="module")
def jax_case():
    """One JAX state of 4 members, the guidance, a batch and a key, and the
    JAX package's full step on a (2, 2) mesh of virtual devices."""
    jg = JaxGuidance(**JAX_GUIDANCE)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(0), np.zeros((1, TM.IMG, TM.IMG, 3))))
    tx = jax_make_optimizer("Adam", TM.LR)
    js = jax_create_member_states(jax_model(), jax.random.PRNGKey(1), tx, 4)
    images, labels = (t.numpy() for t in TM.batch(5))
    key = jax.random.PRNGKey(6)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("member", "data"))
    member, data, rep = (NamedSharding(mesh, s) for s in (P("member"), P("data"), P()))
    step = jax_make_full_train_step(jg, jax_model(), tx, JaxSchedule.create("linear", TM.T_STEPS, 1e-4, 0.02), 4, 2)
    st_shard = jax.tree.map(lambda _: member, js)
    sharded = jax.jit(step, in_shardings=(st_shard, jax.tree.map(lambda _: rep, gvars), data, data, rep),
                      out_shardings=(st_shard, member))
    new, losses = sharded(jax.device_put(js, st_shard), gvars, images, labels, key)
    return {"state": js, "gvars": gvars, "images": images, "labels": labels, "key": key, "mesh": mesh,
            "new": new, "losses": np.asarray(losses)}


@pytest.fixture(scope="module")
def world(jax_case, tmp_path_factory):
    """Every multi-rank case of this file, in one group of 4 ranks."""
    tmp = tmp_path_factory.mktemp("mesh")
    t, noise = jax_multi_draws(jax_case["key"], 4, TM.B, TM.T_STEPS, 2)
    state = member_state_from_jax(jax_case["state"])
    torch.save({"state": state, "guidance": guidance_from_flax(jax_case["gvars"]),
                "images": torch.from_numpy(jax_case["images"]), "labels": torch.from_numpy(jax_case["labels"]),
                "t": t, "noise": noise, "min_size": FSDP_MIN}, tmp / "inputs.pt")
    save_train_state(str(tmp / "one_process_ckpt"), state, {"kind": "diffusion_members"})
    out = TM.run_world(TM.train_world, 4, tmp, str(tmp / "inputs.pt"), str(tmp / "mesh_ckpt"),
                       str(tmp / "one_process_ckpt"))
    return out, state, tmp


# ------------------------------------------------------------ pure Python


@pytest.mark.parametrize("n,m", [(8, 5), (8, 10), (8, 8), (4, 6), (4, 5), (4, 4), (2, 2), (1, 3), (6, 4)])
def test_factor_mesh_matches_jax(n, m):
    assert factor_mesh(n, m) == jax_factor_mesh(n, m)


@pytest.mark.parametrize("s,m", [(5, 5), (10, 5), (2, 4), (4, 2), (3, 5), (1, 1), (6, 4)])
def test_multislice_factor_matches_jax(s, m):
    assert multislice_factor(s, m) == jax_multislice_factor(s, m)


@pytest.mark.parametrize("num_slices", [1, 2, 4, 8])
def test_group_by_slice_matches_jax(num_slices):
    """Ranks 0..7 split as the JAX package splits its 8 virtual devices
    (which carry no slice index), by position."""
    devices = jax.devices()[:8]
    want = [[devices.index(d) for d in g] for g in jax_group_devices_by_slice(devices, num_slices)]
    assert group_devices_by_slice(range(8), num_slices) == want


def test_group_by_slice_reads_the_node_size_and_refuses_ragged_groups(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert group_devices_by_slice(range(8)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert group_devices_by_slice(range(8), local_world_size=2)[1] == [2, 3]
    with pytest.raises(ValueError, match="equal slices"):
        group_devices_by_slice(range(6), 4)
    with pytest.raises(ValueError, match="ragged"):
        group_devices_by_slice(range(6), local_world_size=4)


def test_describe_mesh_matches_jax(world):
    out, _, _ = world
    shape, ranks, across, spans = out["multislice"]
    assert shape == (2, 2) and ranks == [[0, 1], [2, 3]]
    devices = np.asarray(jax.devices()[:4])
    assert across == jax_describe_mesh(Mesh(devices.reshape(2, 2), ("member", "data")), 2)
    assert spans == jax_describe_mesh(Mesh(devices.reshape(1, 4), ("member", "data")), 2)


@pytest.mark.parametrize("min_size", [FSDP_MIN, 2**18])
def test_fsdp_plan_matches_fsdp_shardings(world, jax_case, min_size):
    """The leaves whose second axis shards over 'data' on a (2, 2) mesh: the
    port's names against the JAX shardings of the same state, leaf by leaf
    through the weight bridge's names."""
    out, state, _ = world
    mesh = jax_make_mesh(4, num_members=2)
    assert mesh.devices.shape == (2, 2)
    shard = fsdp_shardings(jax_case["state"], mesh, min_size=min_size)
    specs = {"params": shard.params, "batch_stats": shard.batch_stats}
    sharded = jax.tree.map(lambda s: s.spec == P("member", "data"), specs)
    want = {k for k, v in member_state_from_jax_names(sharded).items() if v}
    assert set(out["fsdp_plan"][min_size]) == want
    if min_size == FSDP_MIN:
        assert {"enc_lin1.weight", "lin2.linear.weight"} <= want
    else:
        assert want == {"enc_lin1.weight"}  # (4, 3072, 32): the one leaf of 2^18 elements or more


def member_state_from_jax_names(tree):
    """A flax params/batch_stats tree of booleans by the port's names."""
    from ladine_tpu_torch.utils.convert import _flax_members_table, _get

    return {key: bool(_get(tree, path)) for key, path, _ in _flax_members_table(tree)}


# ---------------------------------------------------------------- train steps


@pytest.mark.parametrize("name", list(TM.TRAIN_CASES))
def test_sharded_step_matches_one_process(world, name):
    out, _, _ = world
    got, ref = out[name], TM.train_case(name)
    lowmem, fsdp = TM.TRAIN_CASES[name][4], TM.TRAIN_CASES[name][3] is not None
    assert bool(got["fsdp"]) == fsdp and (not fsdp or "enc_lin1.weight" in got["fsdp"])
    for a, b in zip(got["losses"], ref["losses"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for k, v in ref["state"]["params"].items():
        np.testing.assert_allclose(got["state"]["params"][k], v, rtol=0, atol=2.1e-3, err_msg=k)
    for k, v in ref["state"]["batch_stats"].items():
        np.testing.assert_allclose(got["state"]["batch_stats"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    for part in ("mu", "ema"):
        for k, v in ref["state"][part].items():
            g = got["state"][part][k]
            if part == "mu" and k in PRE_BN:
                continue
            if lowmem:
                # the same bits: one bfloat16 step apart where the float32
                # value moved across a rounding edge (bits of their own would
                # put about half of a leaf a step apart)
                apart = g != v
                assert np.mean(apart) <= 1e-2 or k in PRE_BN, (part, k, np.mean(apart))
                # one bfloat16 step of its own value beyond the float32 bar
                atol = 2e-5 * np.abs(v).max() if part == "mu" else EMA_ATOL
                np.testing.assert_allclose(g, v, rtol=2.0**-7, atol=atol, err_msg=k)
            elif part == "mu":
                np.testing.assert_allclose(g, v, rtol=0, atol=2e-5 * np.abs(v).max(), err_msg=k)
            else:
                np.testing.assert_allclose(g, v, rtol=0, atol=EMA_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["state"]["count"], ref["state"]["count"])
    np.testing.assert_array_equal(got["state"]["step"], ref["state"]["step"])
    assert got["next_draw"] == ref["next_draw"]
    if "aux_loss" in ref:
        np.testing.assert_allclose(got["aux_loss"], ref["aux_loss"], rtol=1e-5)
        for k, v in ref["gparams"].items():
            np.testing.assert_allclose(got["gparams"][k], v, rtol=0, atol=2.1e-3, err_msg=k)


def test_sharded_full_step_matches_the_jax_sharded_step(world, jax_case):
    out, _, _ = world
    got = out["vs_jax"]
    np.testing.assert_allclose(got["losses"], jax_case["losses"], rtol=1e-5)
    want = member_state_from_jax(jax_case["new"])
    for k, v in want.params.items():
        np.testing.assert_allclose(got["params"][k], t2n(v), rtol=0, atol=2.1e-3, err_msg=k)


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_written_on_the_mesh_loads_in_one_process(world):
    out, state, tmp = world
    assert out["ckpt_files"] == ["ladine_meta.json", "tree.pt"]
    read, _, meta = load_train_state(str(tmp / "mesh_ckpt"))
    assert meta["kind"] == "diffusion_members" and meta["ema_init"] == "zero"
    for part in ("params", "batch_stats", "ema"):
        for k, v in getattr(state, part).items():
            torch.testing.assert_close(getattr(read, part)[k], v, rtol=0, atol=0)
    for k, v in state.opt_state["mu"].items():
        torch.testing.assert_close(read.opt_state["mu"][k], v, rtol=0, atol=0)
    torch.testing.assert_close(read.step, state.step, rtol=0, atol=0)


def test_one_process_checkpoint_loads_on_the_mesh(world):
    out, state, _ = world
    got = out["ckpt_read"]
    want = TM.whole(state)
    for part in ("params", "batch_stats", "mu", "ema"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    np.testing.assert_array_equal(got["step"], want["step"])
