"""The port's ``cli/convert.py`` against ``ladine_tpu/cli/convert.py`` on
the CPU, on a reference ``.pth`` tree that the port's exporters write
(``utils/torch_convert.py``) from seeded tiny modules at the widths of
``configs/synthetic_tiny.yml``: a ViT, three mapping heads and three
members, with and without ``diffusion.include_guidance``.

* Import: both CLIs read the same tree; the port's ``guidance_{DS}`` and
  ``member_{k}`` hold the JAX checkpoints' tensors, bit for bit, through
  ``utils/convert.py``; both predictor artifacts carry the same meta and
  the port's loads and predicts.
* ``--export``: the port's checkpoints go back to the reference tree, bit
  for bit, and equal the JAX CLI's export of its own checkpoints but for
  D4 (``num_batches_tracked`` is 0-d in the port, as torch keeps it, and
  (1,) in the JAX package); ``--eval_ema`` of a training checkpoint writes
  the debiased EMA.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ladine_tpu.cli import convert as jax_convert
from ladine_tpu.utils import load_checkpoint as jax_load
from ladine_tpu_torch.cli import convert as port_convert
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.utils import guidance_from_flax, load_checkpoint, members_from_flax
from ladine_tpu_torch.utils.torch_convert import (
    export_conditional_model,
    export_mapping_mlp,
    export_vit,
    load_torch_state_dict,
    save_torch_state_dict,
)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "synthetic_tiny.yml")
G = dict(num_classes=2, num_members=3, vit_depth=5, img_size=32, patch_size=8, embed_dim=32, num_heads=2,
         mlp_hidden_dims=(32, 16, 8))
M = 3


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _reference_tree(root, guidance: bool):
    """vit_base_patch16_224_ChestXRay.pth, MLPs/block_{k}.pth and
    diffu{k}_ckpt_best_eph0_acc0.0000.pth, from seeded port modules."""
    g = init_random_(SEViTGuidance(**G, device="cpu"), torch.Generator().manual_seed(0))
    m = init_random_(ConditionalModel(M, 32 * 32 * 3, 32, 32, 2, 51, guidance=guidance, device="cpu"),
                     torch.Generator().manual_seed(1))
    os.makedirs(os.path.join(root, "MLPs"))
    save_torch_state_dict(export_vit(g), os.path.join(root, "vit_base_patch16_224_ChestXRay.pth"))
    for k in range(M):
        save_torch_state_dict(export_mapping_mlp(g, k), os.path.join(root, "MLPs", f"block_{k}.pth"))
    members = []
    for k in range(M):
        members.append(os.path.join(root, f"diffu{k}_ckpt_best_eph0_acc0.0000.pth"))
        save_torch_state_dict(export_conditional_model(m, k), members[-1], wrapper_key="noise_estimator")
    return members


@pytest.fixture(scope="module", params=[True, False], ids=["guidance", "no_cat_f_phi"])
def converted(request, tmp_path_factory):
    guidance = request.param
    root = tmp_path_factory.mktemp("convert")
    members = _reference_tree(str(root / "pretrained"), guidance)
    config = CONFIG
    if not guidance:
        config = str(root / "no_cat_f_phi.yml")
        with open(CONFIG) as f, open(config, "w") as out:
            out.write(f.read().replace("diffusion:\n", "diffusion:\n  include_guidance: false\n"))
    argv = ["--pretrained_dir", str(root / "pretrained"), "--diffusion_ckpt", *members, "--config", config,
            "--export_predictor"]
    assert jax_convert.main(argv + ["--cpu", "--out", str(root / "jax")]) == 0
    assert port_convert.main(argv + ["--device", "cpu", "--out", str(root / "port")]) == 0
    return root, members, guidance


def test_import_matches_the_jax_cli(converted):
    root, _, guidance = converted
    tree, meta = load_checkpoint(str(root / "port" / "guidance_ChestXRay"))
    jtree, jmeta = jax_load(str(root / "jax" / "guidance_ChestXRay"))
    want = guidance_from_flax(jax.tree.map(np.asarray, jtree))
    assert sorted(tree["params"]) == sorted(want) and meta["num_members"] == jmeta["num_members"] == M
    for k, v in want.items():
        assert torch.equal(tree["params"][k], v), k
    for k in range(M):
        ours, _ = load_checkpoint(str(root / "port" / f"member_{k}"))
        jvars, _ = jax_load(str(root / "jax" / f"member_{k}"))
        want = members_from_flax(jax.tree.map(lambda a: np.asarray(a)[None], jvars))
        assert sorted(ours) == sorted(want)
        assert ours["lin1.linear.weight"].shape == (1, 4 if guidance else 2, 32)
        for name, v in want.items():
            assert torch.equal(ours[name], v), (k, name)


def test_predictor_artifacts_agree(converted):
    from ladine_tpu_torch.infer import Predictor

    root, _, _ = converted
    with open(root / "port" / "predictor_artifact" / "ladine_meta.json") as f:
        ours = json.load(f)
    with open(root / "jax" / "predictor_artifact" / "ladine_meta.json") as f:
        theirs = json.load(f)
    for key in ("temperature", "mc_trials", "ddim_steps", "ddim_eta", "model"):
        assert ours[key] == theirs[key], key
    assert {k: v for k, v in ours["guidance"].items() if k != "dtype"} == \
        {k: v for k, v in theirs["guidance"].items() if k != "dtype"}
    pred = Predictor.load(str(root / "port" / "predictor_artifact"), device="cpu", mc_trials=2, ddim_steps=5)
    out = pred.predict(np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32))
    assert np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5)


def test_export_round_trips_and_matches_the_jax_export(converted, capsys):
    root, members, _ = converted
    src = str(root / "pretrained")
    port_args = ["--export", "--guidance_ckpt", str(root / "port" / "guidance_ChestXRay"), "--diffusion_ckpt",
                 *(str(root / "port" / f"member_{k}") for k in range(M))]
    jax_args = ["--export", "--guidance_ckpt", str(root / "jax" / "guidance_ChestXRay"), "--diffusion_ckpt",
                *(str(root / "jax" / f"member_{k}") for k in range(M))]
    assert port_convert.main(port_args + ["--device", "cpu", "--out", str(root / "back")]) == 0
    written = _last_json(capsys)
    assert jax_convert.main(jax_args + ["--cpu", "--out", str(root / "jax_back")]) == 0
    capsys.readouterr()
    names = ["vit_base_patch16_224_ChestXRay.pth"] + [os.path.join("MLPs", f"block_{k}.pth") for k in range(M)]
    names += [os.path.basename(p) for p in members]
    assert [os.path.relpath(p, root / "back") for p in [written["vit"], *written["mlps"], *written["members"]]] \
        == names
    for name in names:
        ours = load_torch_state_dict(str(root / "back" / name))
        original = load_torch_state_dict(os.path.join(src, name))
        theirs = load_torch_state_dict(str(root / "jax_back" / name))
        assert sorted(ours) == sorted(original) == sorted(theirs), name
        for k, v in original.items():
            assert torch.equal(ours[k], v), (name, k)
            if k.endswith("num_batches_tracked"):  # D4: 0-d here, (1,) in the JAX package
                assert v.shape == () and theirs[k].shape == (1,) and int(theirs[k]) == int(v)
            else:
                assert torch.equal(theirs[k], v), (name, k)


def test_export_eval_ema_of_a_training_checkpoint(tmp_path, capsys):
    from ladine_tpu_torch.train import create_member_states, ema_params_from_ckpt, make_optimizer
    from ladine_tpu_torch.utils import save_train_state

    compute = ConditionalModel(2, 48, 8, 8, 2, 11, guidance=False, device="meta", dtype=torch.float32)
    states = create_member_states(compute, torch.Generator().manual_seed(0), make_optimizer("Adam"), 2, device="cpu")
    for v in states.ema.values():  # an accumulator a few updates in
        v.normal_(generator=torch.Generator().manual_seed(1))
    states.step.fill_(3)
    ckpt = str(tmp_path / "diffu_all0_ckpt_best_eph2_acc71.5000")
    meta = save_train_state(ckpt, states, {"kind": "diffusion_members", "epoch": 2, "accuracy": 71.5,
                                           "member_idx": None, "ema_rate": 0.9999})
    for eval_ema in (False, True):
        out = str(tmp_path / f"ema{int(eval_ema)}")
        assert port_convert.main(["--export", "--diffusion_ckpt", ckpt, "--device", "cpu", "--out", out]
                                 + (["--eval_ema"] if eval_ema else [])) == 0
        paths = _last_json(capsys)["members"]
        assert [os.path.basename(p) for p in paths] == [f"diffu{k}_ckpt_best_eph2_acc71.5000.pth" for k in range(2)]
        tree, _ = load_checkpoint(ckpt)
        params = ema_params_from_ckpt(tree["states"], meta) if eval_ema else tree["states"]["params"]
        for k, p in enumerate(paths):
            got = load_torch_state_dict(p)
            want = export_conditional_model({**params, **tree["states"]["batch_stats"]}, k)
            assert got["lin1.lin.weight"].shape == (8, 2)  # y_dim inputs: guidance-free
            for name, v in want.items():
                assert torch.equal(got[name], v), (eval_ema, k, name)
