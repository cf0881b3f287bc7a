"""The port's ``Runner`` (``ladine_tpu_torch/cli/runner.py``) against the
JAX package's, and the runner's own cases (the JAX runner's tests of
precompute and light checkpoints, on the port).

Against the JAX runner, on the same config and data:
* the demo batches, ``num_batches`` and the batches each epoch feeds
  (images within 1e-6: the resize; labels and dataset indices exactly);
* the members' learning rate at every step (``warmup_cosine`` with the
  runner's warm-up clamp), captured from each runner's ``make_optimizer``,
  within 1e-6 relative (1e-9 absolute), on int32 step counts;
* best-checkpoint selection and naming, and the epoch a resume starts at,
  with each runner's validation replaced by the same scripted accuracies;
* ``Runner.test`` on the JAX runner's random guidance and members carried
  over, with the JAX draws injected (``tests/torch_parity.py``): the
  samples within 1e-5 and the report's metrics within 1e-4 (float32).
The train steps themselves are held by ``test_torch_train_diffusion.py``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import ladine_tpu.cli.runner as JR
import ladine_tpu_torch.cli.runner as TR
import ladine_tpu_torch.infer.evaluator as tev
from ladine_tpu.config import Config as JaxConfig
from ladine_tpu.infer import EvalConfig as JaxEvalConfig
from ladine_tpu_torch.config import Config
from ladine_tpu_torch.ops import ddim_timesteps
from ladine_tpu_torch.utils import guidance_from_flax, load_checkpoint_meta, members_from_flax
from torch_parity import jax_eval_draws, one_torch_thread  # noqa: F401 (autouse)

TINY = {
    "data": {"dataset": "PathMNIST", "num_classes": 2, "preprocess": "grayscaled"},
    "model": {"image_size": 16, "patch_size": 8, "embed_dim": 16, "vit_depth": 5, "num_heads": 2,
              "mlp_hidden_dims": [16, 8, 8], "feature_dim": 16, "hidden_dim": 16, "data_dim": 768},
    "diffusion": {"timesteps": 10, "num_members": 5},
    "training": {"batch_size": 8, "n_epochs": 4, "warmup_epochs": 1, "validation_freq": 1, "logging_freq": 1000},
    "testing": {"batch_size": 6, "mc_trials": 2, "drop_last": False},
    "sampling": {"batch_size": 6},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A two-class pathmnist.npz (class 1 brighter), 24 / 9 / 7 images (the
    JAX runner meshes its 8 CPU devices: a train batch must tile 8)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(4)
    z = {}
    for split, n in (("train", 24), ("val", 9), ("test", 7)):
        labels = rng.integers(0, 2, n)
        z[f"{split}_images"] = ((rng.random((n, 28, 28, 3)) * 0.2 + labels[:, None, None, None] * 0.6)
                                * 255).astype(np.uint8)
        z[f"{split}_labels"] = labels.reshape(-1, 1)
    np.savez(root / "pathmnist.npz", **z)
    return str(root)


def _configs(root, **sections):
    d = {k: dict(v) for k, v in TINY.items()}
    d["data"]["dataroot"] = root
    for sec, kv in sections.items():
        d[sec] = {**d.get(sec, {}), **kv}
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _runners(tmp_path, root, demo=False, **sections):
    jc, tc = _configs(root, **sections)
    return (JR.Runner(jc, log_dir=str(tmp_path / "jax"), demo=demo),
            TR.Runner(tc, log_dir=str(tmp_path / "torch"), demo=demo, device="cpu"))


def test_demo_batches_equal_jax(tmp_path):
    jr, tr = _runners(tmp_path, None, demo=True)
    for bs in (8, 70):
        for (jx, jy), (tx, ty) in zip(jr._demo_batches(batch=bs), tr._demo_batches(batch=bs)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        jb = list(jr.batches("train", bs, with_indices=True))
        tb = list(tr.batches("train", bs, with_indices=True))
        for j, t in zip(jb, tb):
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a, b)
    assert tr.num_batches("train", 8) == jr.num_batches("train", 8) == 3


def test_num_batches_and_epoch_batches_equal_jax(tmp_path, corpus):
    jr, tr = _runners(tmp_path, corpus)
    for split in ("train", "valid", "test"):
        for bs in (6, 8):
            for drop_last in (False, True):
                assert tr.num_batches(split, bs, drop_last) == jr.num_batches(split, bs, drop_last)
    for epoch in range(3):
        jb = list(jr.batches("train", 8, shuffle=True, seed=epoch, with_indices=True))
        tb = list(tr.batches("train", 8, shuffle=True, seed=epoch, with_indices=True))
        assert len(jb) == len(tb) == 3
        for (jx, jy, ji), (tx, ty, ti) in zip(jb, tb):
            np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(ti, ji)


class _Stop(Exception):
    pass


def _captured_lr(monkeypatch, module, runner, seed):
    """The learning-rate argument of the runner's member optimizer (its
    train() stopped when the member states are made)."""
    got = {}
    real = module.make_optimizer

    def capture(name, lr, *args, **kwargs):
        got["lr"] = lr
        return real(name, lr, *args, **kwargs)

    def stop(*_, **__):
        raise _Stop

    monkeypatch.setattr(module, "make_optimizer", capture)
    monkeypatch.setattr(module, "create_member_states", stop)
    with pytest.raises(_Stop):
        runner.train(seed, epochs=runner.config.training.n_epochs)
    monkeypatch.undo()
    return got["lr"]


@pytest.mark.parametrize("epochs,warmup,schedule", [(4, 1, True), (3, 40, True), (30, 40, True), (2, 1, False)])
def test_learning_rate_each_step_equals_jax(tmp_path, corpus, monkeypatch, epochs, warmup, schedule):
    jr, tr = _runners(tmp_path, corpus, training={"n_epochs": epochs, "warmup_epochs": warmup},
                      optim={"lr_schedule": schedule, "min_lr": 1e-5})
    jlr = _captured_lr(monkeypatch, JR, jr, jax.random.PRNGKey(0))
    tlr = _captured_lr(monkeypatch, TR, tr, 0)
    if not schedule:
        assert jlr == tlr == 1e-3
        return
    n = epochs * tr.num_batches("train", 8) + 2
    # int32 counts, as each optimizer passes its step count (the schedule tests' tolerance)
    want = np.asarray(jlr(jax.numpy.arange(n, dtype=jax.numpy.int32)))
    got = tlr(torch.arange(n, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def _scripted(monkeypatch, runner, accs):
    seq = iter(accs)
    monkeypatch.setattr(runner, "_validate", lambda *a, **k: next(seq))


def _bests(log_dir):
    return sorted(d for d in os.listdir(log_dir) if d.startswith("diffu") and not d.endswith("_aux"))


def test_best_checkpoints_and_resume_equal_jax(tmp_path, corpus, monkeypatch):
    jr, tr = _runners(tmp_path, corpus)
    accs = [50.0, 75.0, 60.0, 80.0]
    _scripted(monkeypatch, jr, accs)
    _scripted(monkeypatch, tr, accs)
    jout = jr.train(jax.random.PRNGKey(0), epochs=4)
    tout = tr.train(0, epochs=4)
    assert _bests(str(tmp_path / "torch")) == _bests(str(tmp_path / "jax")) == [
        "diffu_all0_ckpt_best_eph0_acc50.0000", "diffu_all0_ckpt_best_eph1_acc75.0000",
        "diffu_all0_ckpt_best_eph3_acc80.0000"]
    assert os.path.basename(tout["best_ckpt_path"]) == os.path.basename(jout["best_ckpt_path"])
    assert tout["steps"] == jout["steps"] == 12
    keys = ("epoch", "accuracy", "kind", "light", "member_idx", "ema_init", "ema_rate", "lowmem")
    for name in _bests(str(tmp_path / "torch")):
        jm = load_checkpoint_meta(str(tmp_path / "jax" / name))
        tm = load_checkpoint_meta(str(tmp_path / "torch" / name))
        assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    for side in ("jax", "torch"):
        with open(tmp_path / side / "train_complete.json") as f:
            assert json.load(f)["steps"] == 12
    # resume from epoch 1's checkpoint: epochs 2 and 3 run, and the restored
    # best (75) keeps epoch 2's 70 from being saved
    monkeypatch.undo()
    jr2, tr2 = _runners(tmp_path / "resume", corpus)
    _scripted(monkeypatch, jr2, [70.0, 90.0])
    _scripted(monkeypatch, tr2, [70.0, 90.0])
    name = "diffu_all0_ckpt_best_eph1_acc75.0000"
    jres = jr2.train(jax.random.PRNGKey(1), epochs=4, resume_from=str(tmp_path / "jax" / name))
    tres = tr2.train(1, epochs=4, resume_from=str(tmp_path / "torch" / name))
    assert tres["steps"] == jres["steps"] == 6
    assert _bests(str(tmp_path / "resume" / "torch")) == _bests(str(tmp_path / "resume" / "jax")) == [
        "diffu_all0_ckpt_best_eph3_acc90.0000"]
    # one member's run names its checkpoint after the member, as the JAX
    # runner does (best_checkpoint_name("diffu", k, ...))
    monkeypatch.undo()
    _, tr3 = _runners(tmp_path / "member", corpus)
    _scripted(monkeypatch, tr3, [55.0])
    t3 = tr3.train(2, epochs=1, member_idx=2)
    assert _bests(str(tmp_path / "member" / "torch")) == ["diffu2_ckpt_best_eph0_acc55.0000"]
    assert load_checkpoint_meta(t3["best_ckpt_path"])["member_idx"] == 2


class _Injected(tev.EvalPipeline):
    """An evaluation pipeline that takes each batch's draws from a list."""

    def __call__(self, images, labels, generator=None, draws=None, seconds=None):
        return super().__call__(images, labels, generator, self.queue.pop(0), seconds)


def test_runner_test_equals_jax_report(tmp_path):
    jr, tr = _runners(tmp_path, None, demo=True, testing={"batch_size": 10})
    gvars = jr.init_guidance(jax.random.PRNGKey(0))
    stacked = jr.init_members(jax.random.PRNGKey(1))
    kw = dict(mc_trials=2, temperature=0.2, ddim_steps=5, noise_std=0.05, brightness=0.1, contrast=0.8,
              attack_name="FGSM", attack_eps=0.03)
    jcfg, tcfg = JaxEvalConfig(**kw), tev.EvalConfig(**kw)
    key = jax.random.PRNGKey(21)
    want = jr.test(key, stacked, gvars, jcfg)
    # the JAX evaluator splits its key once a batch; the port injects those draws
    n_draws = len(ddim_timesteps(tr.sched.num_timesteps, 5))
    queue = []
    for images, _ in tr.batches("test", 10):
        key, sub = jax.random.split(key)
        queue.append(jax_eval_draws(sub, tcfg, images.shape, 5, n_draws)[0])
    tg = {"params": guidance_from_flax(gvars)}
    ts = members_from_flax(stacked)
    pipe = tev.make_eval_pipeline(tr.guidance_module(tg), tr.members_module(ts), tr.sched, tcfg, device="cpu")
    pipe.__class__, pipe.queue = _Injected, queue
    got = tr.test(torch.Generator().manual_seed(0), ts, tg, tcfg, pipeline=pipe)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["samples"], np.asarray(want["samples"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    for k in ("majority_vote_accuracy", "mean_confidence_accuracy", "ece", "nll", "brier", "temperature",
              "num_samples", "num_instances"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert got["per_member_mv_accuracy"] == want["per_member_mv_accuracy"]


# ------------------------------------------------ the runner's own cases


def _demo(tmp_path, name="run", **sections):
    cfg = Config()
    cfg.diffusion.timesteps, cfg.diffusion.num_members, cfg.training.batch_size = 10, 3, 8
    for sec, kv in sections.items():
        for k, v in kv.items():
            setattr(getattr(cfg, sec), k, v)
    return TR.Runner(cfg, log_dir=str(tmp_path / name), demo=True, device="cpu")


def test_pretrain_and_evaluate_guidance(tmp_path):
    r = _demo(tmp_path)
    gvars = r.init_guidance(torch.Generator().manual_seed(0))
    before = r.evaluate_guidance(gvars)
    gvars = r.pretrain_guidance(gvars, steps=40)
    after = r.evaluate_guidance(gvars)
    assert after >= before and after > 60.0  # the JAX runner test's bar: separable data learns fast


def test_single_member_out_of_range_and_precompute_rejects_joint(tmp_path):
    r = _demo(tmp_path)
    out = r.train(0, epochs=1, member_idx=1)
    assert out["states"].step.shape == (1,)
    with pytest.raises(ValueError, match="out of range"):
        r.train(0, epochs=1, member_idx=7)
    with pytest.raises(ValueError, match="FROZEN"):
        r.train(0, epochs=1, precompute_yhat=True, joint_train=True)


def test_precompute_matches_in_step_guidance(tmp_path, corpus):
    """The same seed with the frozen guidance's y0_hat precomputed: the same
    losses, accuracy and (to Adam's sign-sensitive first steps, the JAX
    test's bound) parameters as the in-step guidance run."""
    _, tc = _configs(corpus)
    outs = {}
    for pre in (False, True):
        r = TR.Runner(tc, log_dir=str(tmp_path / f"pre{int(pre)}"), device="cpu")
        outs[pre] = r.train(3, epochs=2, precompute_yhat=pre)
    assert outs[True]["best_accuracy"] == outs[False]["best_accuracy"]
    assert outs[True]["steps"] == outs[False]["steps"]
    for k, v in outs[False]["states"].params.items():
        np.testing.assert_allclose(outs[True]["states"].params[k].numpy(), v.numpy(), atol=1.3e-2)
    # the y0_hat rows are the guidance's softmax of each sample
    r = TR.Runner(tc, log_dir=str(tmp_path / "rows"), device="cpu")
    gvars = r.init_guidance(torch.Generator().manual_seed(5))
    gmod = r.guidance_module(gvars)
    yh = r.precompute_yhat(gmod, "valid", (0, 2, 5), 4)
    images, _ = next(iter(r.batches("valid", 9)))
    with torch.no_grad():
        want = torch.softmax(gmod.heads_subset(torch.from_numpy(images), (0, 2, 5)), -1).numpy()
    np.testing.assert_allclose(yh, want.transpose(1, 0, 2), rtol=0, atol=1e-6)


def test_light_checkpoint_payload_refuses_resume_and_evaluates(tmp_path):
    r = _demo(tmp_path, model={"dtype": "bfloat16"})
    out = r.train(3, epochs=1, light_ckpt=True)
    meta = load_checkpoint_meta(out["best_ckpt_path"])
    assert meta["light"] is True and meta["ema_init"] == "zero" and meta["ema_rate"] > 0
    from ladine_tpu_torch.utils import load_checkpoint

    tree, _ = load_checkpoint(out["best_ckpt_path"])
    assert sorted(tree["states"]) == ["batch_stats", "ema", "params", "step"]
    assert tree["states"]["params"]["lin2.linear.weight"].dtype == torch.bfloat16
    assert tree["guidance"] is not None  # a random demo guidance is stored, not referenced
    raw, g, _ = r.load_members_from_train_ckpt(out["best_ckpt_path"])
    ema, _, _ = r.load_members_from_train_ckpt(out["best_ckpt_path"], use_ema=True)
    assert g is not None and raw.keys() == ema.keys()
    assert not torch.equal(raw["lin2.linear.weight"], ema["lin2.linear.weight"])
    with pytest.raises(ValueError, match="light_ckpt"):
        r.train(4, epochs=2, resume_from=out["best_ckpt_path"])
    # an fp32 runner reads the bf16-stored weights as float32
    r32 = _demo(tmp_path, "fp32")
    v32, _, _ = r32.load_members_from_train_ckpt(out["best_ckpt_path"], eval_cast=True)
    assert v32["lin2.linear.weight"].dtype == torch.float32


def test_light_checkpoint_references_stage1_and_prunes(tmp_path, corpus, monkeypatch):
    from ladine_tpu_torch.utils import export_guidance_stage1, load_checkpoint

    _, tc = _configs(corpus)
    r = TR.Runner(tc, log_dir=str(tmp_path / "run"), device="cpu")
    gvars = r.init_guidance(torch.Generator().manual_seed(0), host_only=True)
    export_guidance_stage1(gvars, str(tmp_path / "models"), "PathMNIST")
    vit_ckpt = str(tmp_path / "models" / "vit_PathMNIST")
    mlp_dir = str(tmp_path / "models" / "PathMNIST" / "MLPs")
    _scripted(monkeypatch, r, [40.0, 60.0])
    out = r.train(0, epochs=2, light_ckpt=True, vit_ckpt=vit_ckpt, mlp_dir=mlp_dir, precompute_yhat=True)
    monkeypatch.undo()
    meta = load_checkpoint_meta(out["best_ckpt_path"])
    assert meta["guidance_src"]["vit_ckpt"] == os.path.abspath(vit_ckpt)
    assert load_checkpoint(out["best_ckpt_path"])[0]["guidance"] is None
    assert _bests(str(tmp_path / "run")) == ["diffu_all0_ckpt_best_eph1_acc60.0000"]  # the first was pruned
    _, g, _ = r.load_members_from_train_ckpt(out["best_ckpt_path"])
    for k, v in gvars["params"].items():
        assert torch.equal(g["params"][k], v)
    # the y0_hat cache beside the log dirs: a second run hits it and, with
    # light checkpoints, never loads the guidance
    caches = [f for f in os.listdir(tmp_path) if f.startswith("yhat_cache_")]
    assert len(caches) == 1
    r2 = TR.Runner(tc, log_dir=str(tmp_path / "run2"), device="cpu")
    monkeypatch.setattr(r2, "init_guidance", lambda *a, **k: pytest.fail("the guidance was loaded"))
    r2.train(0, epochs=1, light_ckpt=True, vit_ckpt=vit_ckpt, mlp_dir=mlp_dir, precompute_yhat=True)


def test_joint_train_saves_and_resumes_aux(tmp_path):
    r = _demo(tmp_path, diffusion={"num_members": 2}, training={"validation_freq": 1})
    out = r.train(0, epochs=1, joint_train=True)
    ck = out["best_ckpt_path"]
    assert os.path.isdir(ck + "_aux")
    res = r.train(1, epochs=2, joint_train=True, resume_from=ck)
    assert res["steps"] == 3  # epoch 1 only
    assert int(res["states"].step[0]) == 6


def test_resume_refuses_another_lowmem_setting(tmp_path):
    r = _demo(tmp_path)
    out = r.train(0, epochs=1)
    rl = _demo(tmp_path, "lowmem", optim={"lowmem": True})
    with pytest.raises(ValueError, match="optim.lowmem=false"):
        rl.train(0, epochs=2, resume_from=out["best_ckpt_path"])


def test_mesh_is_none_on_one_device_and_refused_across_cards(tmp_path, monkeypatch, caplog):
    """Without a process group there is no mesh: one process that sees two
    cards runs on one, FSDP asked for or not, and the log says how to
    launch a rank a card (the mesh itself: ``tests/test_torch_parallel*.py``)."""
    r = _demo(tmp_path)
    assert r._maybe_mesh(8) is None
    r.device = torch.device("cuda")  # as on a machine with two cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert r._maybe_mesh(8) is None  # no mesh asked for: one card, said in the log
    r.config.model.fsdp = True
    caplog.clear()
    assert r._maybe_mesh(8) is None
    assert "torchrun --nproc_per_node 2" in caplog.text
