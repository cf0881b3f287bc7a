"""The port's AOT serving bundle against the live port Predictor and against
ladine_tpu's bundle, on the CPU (mirrors tests/test_serve.py's bundle tests).

``Predictor.export_serving`` writes one ``torch.export`` program per batch
size with the run weights as inputs; ``ExportedPredictor`` serves it
without model code. On the CPU a bundle equals the live predictor bit for
bit on the same generator. With the JAX sampler's draws injected it equals
the JAX ``ExportedPredictor`` within tests/test_torch_serve.py's tolerances
(float32: rtol 1e-4 / atol 1e-5; int8: 1e-3), votes equal. The
bundle from the export CLI, and the kernels' custom ops, are held in
tests/test_torch_export_cli.py.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladine_tpu.infer import ExportedPredictor as JaxExportedPredictor
from ladine_tpu.infer import Predictor as JaxPredictor
from ladine_tpu.models import ConditionalModel as JaxConditionalModel
from ladine_tpu.models import SEViTGuidance as JaxGuidance
from ladine_tpu.ops import DiffusionSchedule as JaxSchedule
from ladine_tpu_torch.infer import ExportedPredictor, MicroBatcher, Predictor
from ladine_tpu_torch.infer.serve import PRESETS
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.utils import guidance_from_flax, members_from_flax
from torch_parity import j2t, jax_ensemble_noise, jax_members

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = dict(num_classes=2, num_members=3, vit_depth=3, img_size=16, patch_size=8, embed_dim=16,
         num_heads=2, mlp_hidden_dims=(16, 8, 8))
T = 20
SERVING = dict(PRESETS["serving"], ddim_steps=3)


@pytest.fixture(scope="module")
def parts():
    jg = JaxGuidance(**G)
    gvars = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    jm = JaxConditionalModel(data_dim=768, feature_dim=8, hidden_dim=8, y_dim=2, n_steps=T + 1)
    stacked = jax_members(jm, 3, 768)
    g = SEViTGuidance(**G, device="cpu")
    g.load_state_dict(guidance_from_flax(gvars))
    m = ConditionalModel(3, 768, 8, 8, 2, T + 1, device="cpu")
    m.load_state_dict(members_from_flax(stacked))
    return dict(jg=jg, gvars=gvars, jm=jm, stacked=stacked, g=g, m=m)


def _port(parts, **kw) -> Predictor:
    return Predictor(guidance=parts["g"], model=parts["m"],
                     sched=DiffusionSchedule.create("linear", T, 1e-4, 0.02, device="cpu"),
                     temperature=0.2, mc_trials=2, device="cpu", **kw)


def _images(seed, b=4):
    return np.random.default_rng(seed).random((b, 16, 16, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles(parts, tmp_path_factory):
    """The live parity and serving predictors, and their bundles: parity at
    batch sizes (2, 4), serving at MicroBatcher.bucket_sizes(4)."""
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, kw, sizes in (("parity", dict(ddim_steps=0), (2, 4)),
                            ("serving", SERVING, MicroBatcher.bucket_sizes(4))):
        live = _port(parts, **kw)
        live.export_serving(str(root / name), batch_sizes=sizes)
        out[name] = (live, str(root / name), ExportedPredictor.load(str(root / name), device="cpu"))
    return out


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ["parity", "serving"])
def test_bundle_equals_the_live_predictor(bundles, name):
    live, _, served = bundles[name]
    assert served.settings["mc_trials"] == live.mc_trials
    assert served.settings["ddim_steps"] == live.ddim_steps
    for b in (2, 4):
        want = live.predict(_images(9, b), generator=_gen(11))
        got = served.predict(_images(9, b), generator=_gen(11))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} at batch {b}")


def test_bundle_weights_are_inputs_not_constants(bundles):
    _, path, served = bundles["parity"]
    assert sorted(served.programs) == [2, 4]
    assert served.weights["model.lin2.linear.weight"].dtype == torch.float32
    program = torch.export.load(os.path.join(path, "programs", "serving_b4.pt2"))
    assert not program.state_dict and program.example_inputs is None
    assert sum(t.numel() for t in program.constants.values() if isinstance(t, torch.Tensor)) < 64


@pytest.mark.parametrize("name", ["parity", "serving"])
def test_bundle_matches_the_jax_bundle(parts, bundles, tmp_path, name):
    live, _, served = bundles[name]
    kw = dict(ddim_steps=0) if name == "parity" else SERVING
    ref = JaxPredictor(guidance=parts["jg"], guidance_vars=parts["gvars"], model=parts["jm"],
                       stacked_vars=parts["stacked"], sched=JaxSchedule.create("linear", T, 1e-4, 0.02),
                       temperature=0.2, mc_trials=2, **kw)
    ref.export_serving(str(tmp_path / "jax"), batch_sizes=(4,))
    jax_served = JaxExportedPredictor.load(str(tmp_path / "jax"))
    images, key = _images(3), jax.random.PRNGKey(7)
    want = jax_served.predict(images, key=key)
    noise = jax_ensemble_noise(key, 3, 2, (4, 2), served.noise_shape[0])
    got = served.predict(images, noise=j2t(noise))
    tol = dict(rtol=1e-4, atol=1e-5) if name == "parity" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got["majority_vote"], np.asarray(want["majority_vote"]))
    for out in ("probs", "piw", "mc_variance"):
        np.testing.assert_allclose(got[out], np.asarray(want[out]), err_msg=out, **tol)


def test_refusals(parts, bundles, tmp_path):
    _, path, served = bundles["parity"]
    with pytest.raises(ValueError, match="batch sizes"):
        served.predict(_images(0, 3))
    # a plain predictor artifact is not a bundle
    plain = str(tmp_path / "plain")
    _port(parts, ddim_steps=5).save(plain)
    os.makedirs(str(tmp_path / "not_bundle" / "programs"))
    shutil.copytree(plain, str(tmp_path / "not_bundle" / "weights"))
    with pytest.raises(ValueError, match="not an export_serving bundle"):
        ExportedPredictor.load(str(tmp_path / "not_bundle"), device="cpu")
    # a bundle without programs
    shutil.copytree(os.path.join(path, "weights"), str(tmp_path / "empty" / "weights"))
    with pytest.raises(ValueError, match="no serving programs"):
        ExportedPredictor.load(str(tmp_path / "empty"), device="cpu")
    # a bundle exported on another device type (the card's, here told by its meta)
    other = str(tmp_path / "other")
    shutil.copytree(path, other)
    meta_path = os.path.join(other, "weights", "ladine_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["device_type"] == "cpu"
    with open(meta_path, "w") as f:
        json.dump({**meta, "device_type": "cuda"}, f)
    with pytest.raises(ValueError, match="exported on cuda and runs there only"):
        ExportedPredictor.load(other, device="cpu")


def test_bundle_behind_a_microbatcher(bundles):
    _, _, served = bundles["serving"]
    assert sorted(served.programs) == [1, 2, 4]
    assert MicroBatcher.bucket_sizes(4) == [1, 2, 4]
    batcher = MicroBatcher(served.predict, max_batch=4, max_wait_ms=1.0)
    try:
        out = batcher.predict(_images(4, 3))
        assert out["probs"].shape == (3, 2) and np.isfinite(out["probs"]).all()  # pad row dropped
    finally:
        batcher.close()


def test_loading_a_bundle_imports_no_model_code(bundles, tmp_path):
    _, path, _ = bundles["serving"]
    one = str(tmp_path / "one")
    shutil.copytree(os.path.join(path, "weights"), os.path.join(one, "weights"))
    os.makedirs(os.path.join(one, "programs"))
    shutil.copy(os.path.join(path, "programs", "serving_b1.pt2"), os.path.join(one, "programs"))
    code = (
        "import sys, numpy as np\n"
        "from ladine_tpu_torch.infer import ExportedPredictor\n"
        f"e = ExportedPredictor.load({one!r}, device='cpu')\n"
        "out = e.predict(np.zeros((1, 16, 16, 3), np.float32))\n"
        "assert np.isfinite(out['probs']).all()\n"
        "print(sorted(m for m in sys.modules if m.startswith('ladine_tpu_torch.models')))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"
