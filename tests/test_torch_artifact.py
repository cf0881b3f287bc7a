"""Predictor.save / Predictor.load of the port against ladine_tpu's, on the CPU.

The port writes its own artifact (``utils/checkpoint.py``: ``torch.save``
tree + ``ladine_meta.json``) and cannot read the JAX package's orbax one,
so the two are held against each other through what they must share: the
meta sidecar (the same keys and values), the settings a load ends with
(preset, then overrides; the legacy-``ddim_eta`` warning), and the
predictions on the same weights and noise (float32, the tolerances of
tests/test_torch_serve.py: rtol 1e-4 / atol 1e-5, votes equal). A save ->
load round trip of the port is exact.
"""

import json
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.infer import Predictor as JaxPredictor
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu_torch.infer import Predictor
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from ladine_tpu_torch.utils.checkpoint import (
    best_checkpoint_name,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
)
from torch_parity import j2t, jax_ensemble_noise, jax_members

G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
T = 20
# settings away from the defaults, so that a dropped one shows
SETTINGS = dict(temperature=0.2, mc_trials=2, ddim_steps=5, ddim_eta=0.5, skip_type="quad",
                noise_prior=True, head_indices=(2, 0, 1))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same predictor saved by both packages (float32 compute)."""
    root = tmp_path_factory.mktemp("artifacts")
    jg = JaxGuidance(**G, dtype=jnp.float32)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    jm = JaxConditionalModel(data_dim=768, feature_dim=8, hidden_dim=8, y_dim=2, n_steps=T + 1,
                             dtype=jnp.float32)
    stacked = jax_members(jm, 3, 768)
    sched = JaxSchedule.create("cosine", T)  # not the default schedule: saved verbatim
    ref = JaxPredictor(guidance=jg, guidance_vars=gvars, model=jm, stacked_vars=stacked, sched=sched,
                       **SETTINGS)
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(3, 768, 8, 8, 2, T + 1, device="cpu")
    m.load_state_dict(members_from_flax(stacked))
    ours = Predictor(guidance=g, model=m, sched=DiffusionSchedule.create("cosine", T, device="cpu"),
                     device="cpu", **SETTINGS)
    ref.save(str(root / "jax"))
    ours.save(str(root / "port"))
    return dict(ref=ref, ours=ours, jax=str(root / "jax"), port=str(root / "port"))


def _meta(path):
    with open(os.path.join(path, "ladine_meta.json")) as f:
        return json.load(f)


def test_meta_has_the_jax_keys_and_values(saved):
    assert _meta(saved["port"]) == _meta(saved["jax"])


def test_round_trip_predicts_as_before_and_as_jax(saved):
    loaded = Predictor.load(saved["port"], device="cpu")
    images = np.random.default_rng(0).random((4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = j2t(jax_ensemble_noise(key, 3, 2, (4, 2), len(loaded._tau)))
    before = saved["ours"].predict(images, noise=noise)
    after = loaded.predict(images, noise=noise)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    want = saved["ref"].predict(images, key=key)
    np.testing.assert_array_equal(after["majority_vote"], np.asarray(want["majority_vote"]))
    for k in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(after[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_load_restores_weights_schedule_and_dtype(saved):
    loaded = Predictor.load(saved["port"], device="cpu")
    for a, b in ((loaded.guidance, saved["ours"].guidance), (loaded.model, saved["ours"].model)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(loaded.sched, saved["ours"].sched))
    assert loaded.model.lin2.linear.weight.dtype == torch.float32
    bf16 = Predictor.load(saved["port"], dtype="bfloat16", device="cpu")
    assert bf16.model.lin2.linear.weight.dtype == torch.bfloat16
    assert bf16.guidance.vit.patch_proj.weight.dtype == torch.bfloat16
    assert bf16.model.norm.running_var.dtype == torch.float32  # BatchNorm stays float32
    bf16.save(saved["port"] + "_bf16")
    assert _meta(saved["port"] + "_bf16")["dtype"] == "bfloat16"
    again = Predictor.load(saved["port"] + "_bf16", device="cpu")  # dtype="artifact"
    assert again.model.lin2.linear.weight.dtype == torch.bfloat16


SETTING_NAMES = ("temperature", "mc_trials", "ddim_steps", "ddim_eta", "skip_type", "noise_prior",
                 "use_int8", "use_int8_encode", "use_int8_pallas", "pallas_fuse_ends", "head_indices")


@pytest.mark.parametrize("preset, overrides", [
    (None, {}),
    ("serving", {}),
    ("fast", dict(ddim_steps=7, temperature=0.3)),  # overrides win over the preset
    ("parity", dict(use_int8_pallas=True, pallas_fuse_ends=True)),
])
def test_preset_then_overrides_as_jax(saved, preset, overrides):
    ours = Predictor.load(saved["port"], preset=preset, device="cpu", **overrides)
    ref = JaxPredictor.load(saved["jax"], preset=preset, **overrides)
    assert {k: getattr(ours, k) for k in SETTING_NAMES} == {k: getattr(ref, k) for k in SETTING_NAMES}


def test_unknown_preset_raises_before_loading():
    with pytest.raises(ValueError, match="unknown preset"):
        Predictor.load("/nonexistent", preset="turbo", device="cpu")


@pytest.mark.parametrize("preset, overrides, warns", [
    (None, {}, True),
    (None, dict(ddim_eta=1.0), False),
    ("serving", {}, False),  # the preset sets eta
    ("parity", {}, True),  # a preset that does not set eta keeps the warning
])
def test_legacy_ddim_eta_warning_as_jax(saved, tmp_path, preset, overrides, warns):
    """An artifact saved before ddim_eta existed loads at eta 0 with a
    warning, unless the caller or the preset sets eta."""
    legacy = {}
    for name in ("jax", "port"):  # each package's artifact, its meta without ddim_eta
        legacy[name] = str(tmp_path / name)
        shutil.copytree(saved[name], legacy[name])
        meta = _meta(legacy[name])
        del meta["ddim_eta"]
        with open(os.path.join(legacy[name], "ladine_meta.json"), "w") as f:
            json.dump(meta, f)
    results = {}
    for name, load in (("jax", lambda p: JaxPredictor.load(p, preset=preset, **overrides)),
                       ("port", lambda p: Predictor.load(p, preset=preset, device="cpu", **overrides))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p = load(legacy[name])
        results[name] = (p.ddim_eta, any("predates ddim_eta" in str(w.message) for w in caught))
    assert results["port"] == results["jax"]
    assert results["port"][1] == warns


def test_checkpoint_layout(tmp_path):
    tree = {"a": torch.arange(3), "b": {"c": torch.ones(2, 2, dtype=torch.bfloat16)}, "n": [1, 2]}
    save_checkpoint(str(tmp_path / "ck"), tree, {"kind": "x", "epoch": 3})
    assert sorted(os.listdir(tmp_path / "ck")) == ["ladine_meta.json", "tree.pt"]
    back, meta = load_checkpoint(str(tmp_path / "ck"))
    assert meta == load_checkpoint_meta(str(tmp_path / "ck")) == {"kind": "x", "epoch": 3}
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["n"] == [1, 2]
    assert load_checkpoint_meta(str(tmp_path / "nothing")) == {}
    assert best_checkpoint_name("diffu", 2, 7, 0.91234) == "diffu2_ckpt_best_eph7_acc0.9123"


def test_load_runs_on_the_card_unless_asked_for_the_cpu(saved, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.load(saved["port"])
    assert Predictor.load(saved["port"], device="cpu").device.type == "cpu"
