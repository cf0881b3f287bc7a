"""``ConditionalModel(guidance=False)`` (the reference's ``--no_cat_f_phi``)
in the port against ``ladine_tpu`` on the CPU.

lin1 takes y_t alone (``y_dim -> feature_dim``) and a y_hat given to eps is
ignored, as in the JAX module. Held, on the same weights (carried by
``utils/convert.py``) and inputs:

* ``eps`` and the eval forward against the JAX module's, and the
  parameter count against ``guidance=True`` (as
  ``tests/test_knobs.py::test_no_cat_f_phi_changes_param_count``);
* every eps path's plain version: the fused path (K1 x 3, lin4), the int8
  path through ``torch._int_mm``, K4's plain version (``use_int8_pallas``)
  and K5's (``pallas_fuse_ends``). The JAX int8 functions concatenate y and
  y_hat unconditionally, so they are given a y_hat of width 0: their lin1
  input is then y alone, the guidance-free model's;
* one member train step against JAX's, from the same state and draws;
* ``Predictor.save``/``load`` and the bundle's meta keep ``guidance``;
* ``cli.main --train --demo --no_cat_f_phi`` in both packages on a cut
  schedule (two epochs of the demo's three batches, T = 10).

Tolerances: float32 1e-5 abs on the float paths (measured ~1e-7); the
int8 paths 1e-4 rel and abs, one int8 code flipped at a rounding boundary
(``tests/test_torch_int8.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.kernels import int8 as jint8
from ladine_tpu.kernels import int8_pallas as jpallas
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu.train import diffusion_trainer as JT
from ladine_tpu.train.optim import make_optimizer as jax_make_optimizer
from ladine_tpu_torch.kernels import int8 as tint8
from ladine_tpu_torch.kernels.int8_eps_fused import int8_eps_pallas_fused
from ladine_tpu_torch.kernels.int8_linear import int8_eps_pallas
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.train import diffusion_trainer as T
from ladine_tpu_torch.train.optim import make_optimizer
from ladine_tpu_torch.utils import member_state_from_jax, members_from_flax
from torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    assert_adam_step, jax_member_draws, jax_members, one_torch_thread, t2n)

M, D, FEAT, Y, STEPS = 3, 48, 32, 2, 21
FLOAT = dict(rtol=0, atol=1e-5)
INT8 = dict(rtol=1e-4, atol=1e-4)


def _member(stacked, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), stacked)


@pytest.fixture(scope="module")
def members():
    jm = JaxConditionalModel(data_dim=D, feature_dim=FEAT, hidden_dim=FEAT, y_dim=Y, n_steps=STEPS, guidance=False)
    stacked = jax_members(jm, M, D)
    m = ConditionalModel(M, D, FEAT, FEAT, Y, STEPS, guidance=False, device="cpu")
    m.load_state_dict(members_from_flax(stacked))
    return jm, stacked, m


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    x = rng.random((5, D)).astype(np.float32)
    f = rng.standard_normal((M, 7, FEAT)).astype(np.float32)
    y = rng.standard_normal((M, 7, Y)).astype(np.float32)
    yhat = rng.dirichlet([1.0, 1.0], size=(M, 7)).astype(np.float32)
    return x, f, y, yhat


def test_lin1_takes_y_alone_and_the_parameter_count_drops(members):
    _, stacked, m = members
    assert m.lin1.linear.weight.shape == (M, Y, FEAT)
    assert stacked["params"]["lin1"]["TorchLinear_0"]["Dense_0"]["kernel"].shape == (M, Y, FEAT)
    with_g = ConditionalModel(M, D, FEAT, FEAT, Y, STEPS, device="meta")
    count = lambda mod: sum(p.numel() for p in mod.parameters())  # noqa: E731
    assert count(with_g) - count(m) == M * Y * FEAT
    with pytest.raises(ValueError, match="requires y_hat"):
        with_g.lin1_input(torch.zeros(1, 2), None)


@pytest.mark.parametrize("t", [0, 7, 20])
def test_eps_and_forward_match_jax_and_ignore_y_hat(members, inputs, t):
    jm, stacked, m = members
    x, f, y, yhat = inputs
    got = m.eps(torch.from_numpy(f), torch.from_numpy(y), t, torch.from_numpy(yhat))
    torch.testing.assert_close(m.eps(torch.from_numpy(f), torch.from_numpy(y), t), got, rtol=0, atol=0)
    xt = torch.from_numpy(x)
    yy = torch.from_numpy(y[:, :5])
    fwd = m(xt, yy, t)
    for i in range(M):
        v = _member(stacked, i)
        want = jm.apply(v, jnp.asarray(f[i]), jnp.asarray(y[i]), jnp.asarray(t), None, method="eps")
        np.testing.assert_allclose(t2n(got[i]), np.asarray(want), **FLOAT)
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(y[i, :5]), jnp.asarray(t), None)
        np.testing.assert_allclose(t2n(fwd[i]), np.asarray(want), **FLOAT)


@pytest.mark.parametrize("path", ["int_mm", "k4", "k5"])
@pytest.mark.parametrize("t", [1, 9])
def test_int8_eps_paths_match_jax(members, inputs, path, t):
    _, stacked, m = members
    _, f, y, yhat = inputs
    port = {"int_mm": tint8.int8_eps, "k4": int8_eps_pallas, "k5": int8_eps_pallas_fused}[path]
    got = port(m, tint8.quantize_member(m), torch.from_numpy(f), torch.from_numpy(y), t, torch.from_numpy(yhat))
    no_guidance = jnp.zeros((f.shape[1], 0), jnp.float32)  # lin1's input is then y alone
    for i in range(M):
        qv = jint8.quantize_member(_member(stacked, i))
        args = (qv, jnp.asarray(f[i]), jnp.asarray(y[i]), jnp.asarray(t), no_guidance)
        if path == "int_mm":
            want = jint8.int8_eps(*args)
        else:
            ref = jpallas.int8_eps_pallas_fused if path == "k5" else jpallas.int8_eps_pallas
            want = ref(*args, block_r=8, block_n=128)
        np.testing.assert_allclose(t2n(got[i]), np.asarray(want), **INT8)


def test_member_step_matches_jax():
    n, lr, data_dim = 16, 1e-3, 3 * 8 * 8
    geometry = dict(feature_dim=FEAT, hidden_dim=FEAT, y_dim=Y, n_steps=STEPS)
    jm = JaxConditionalModel(data_dim=data_dim, guidance=False, **geometry)
    jsched = JaxSchedule.create("linear", STEPS - 1, 1e-4, 0.02)
    sched = DiffusionSchedule.create("linear", STEPS - 1, 1e-4, 0.02, device="cpu")
    tx = jax_make_optimizer("Adam", lr)
    js = JT.create_member_state(jm, jax.random.PRNGKey(1), tx, batch_size=2)
    jstep = jax.jit(JT.make_member_step(jm, tx, jsched))
    compute = ConditionalModel(1, data_dim, FEAT, FEAT, Y, STEPS, guidance=False, device="meta", dtype=torch.float32)
    step = T.make_member_step(compute, make_optimizer("Adam", lr), sched)
    stacked = lambda st: jax.tree.map(lambda v: v[None], st)  # noqa: E731
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, data_dim)).astype(np.float32)
    y0 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    yh = np.array(jax.nn.softmax(rng.standard_normal((n, 2)).astype(np.float32)))
    key = jax.random.PRNGKey(10)
    port = member_state_from_jax(stacked(js))
    assert port.params["lin1.linear.weight"].shape == (1, Y, FEAT)
    js_new, jl = jstep(js, x, y0, yh, key)
    t, noise = jax_member_draws(key, n, STEPS - 1, 2)
    port, loss = step(port, torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(yh), t=t, noise=noise)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    old, ref = member_state_from_jax(stacked(js)), member_state_from_jax(stacked(js_new))
    pre_bn = {"enc_lin1.bias": ..., "enc_lin2.bias": ..., "enc_lin3.bias": ...}
    assert_adam_step(port.params, port.opt_state["mu"], old.opt_state["mu"], ref.opt_state["mu"], ref.params, lr,
                     lead=1, zero_grad=pre_bn)
    for k, v in ref.batch_stats.items():
        np.testing.assert_allclose(t2n(port.batch_stats[k]), t2n(v), **FLOAT, err_msg=k)
    # the hand-off reads guidance=False off lin1's width
    handed = T.conditional_model_from_state(port, use_ema=False, device="cpu")
    assert not handed.guidance and handed.lin1.linear.weight.shape == (1, Y, FEAT)


G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=8, patch_size=4, embed_dim=16, num_heads=2,
         mlp_hidden_dims=(16, 8, 8))


def test_save_load_and_bundle_meta_keep_guidance(members, tmp_path):
    from ladine_tpu_torch.infer import Predictor

    _, _, m = members
    guidance = init_random_(SEViTGuidance(**G, device="cpu"), torch.Generator().manual_seed(0))
    model = ConditionalModel(M, 8 * 8 * 3, FEAT, FEAT, Y, STEPS, guidance=False, device="cpu")
    init_random_(model, torch.Generator().manual_seed(1))
    sched = DiffusionSchedule.create("linear", STEPS - 1, 1e-4, 0.02, device="cpu")
    pred = Predictor(guidance=guidance, model=model, sched=sched, mc_trials=3, ddim_steps=5, device="cpu")
    images = np.random.default_rng(0).random((2, 8, 8, 3)).astype(np.float32)
    want = pred.predict(images, generator=torch.Generator().manual_seed(4))
    pred.save(str(tmp_path / "art"))
    with open(tmp_path / "art" / "ladine_meta.json") as f:
        assert json.load(f)["model"] == {"data_dim": 192, "feature_dim": FEAT, "hidden_dim": FEAT, "y_dim": Y,
                                         "n_steps": STEPS, "arch": "linear", "guidance": False}
    back = Predictor.load(str(tmp_path / "art"), device="cpu")
    assert not back.model.guidance
    got = back.predict(images, generator=torch.Generator().manual_seed(4))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    int8 = Predictor.load(str(tmp_path / "art"), preset="serving", device="cpu", use_int8_pallas=True,
                          pallas_fuse_ends=True)
    out = int8.predict(images)
    assert np.isfinite(out["probs"]).all() and np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5)
    from ladine_tpu_torch.infer.exported import WEIGHTS
    from ladine_tpu_torch.utils import load_checkpoint_meta

    pred.export_serving(str(tmp_path / "bundle"), batch_sizes=(2,))
    settings = load_checkpoint_meta(os.path.join(str(tmp_path / "bundle"), WEIGHTS))["settings"]
    assert settings["guidance"] is False and settings["arch"] == "linear"


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_main_trains_no_cat_f_phi_in_both_packages(tmp_path, capsys):
    from ladine_tpu.cli import main as jax_main
    from ladine_tpu_torch.cli import main as port_main
    from ladine_tpu_torch.utils import load_train_state

    common = ["--train", "--demo", "--no_cat_f_phi", "--timesteps", "10", "--set", "training.n_epochs=2"]
    assert jax_main.main(common + ["--cpu", "--exp", str(tmp_path / "jax")]) == 0
    capsys.readouterr()
    assert port_main.main(common + ["--device", "cpu", "--exp", str(tmp_path / "port")]) == 0
    log = tmp_path / "port" / "logs" / "run"
    with open(log / "train_complete.json") as f:
        done = json.load(f)
    states, _, meta = load_train_state(done["best_ckpt_path"])
    assert states.params["lin1.linear.weight"].shape[1] == 2  # y_dim: y_t alone
    assert np.isfinite(done["best_accuracy"])
    with open(tmp_path / "jax" / "logs" / "run" / "train_complete.json") as f:
        jdone = json.load(f)
    assert jdone["steps"] == done["steps"] == 6
