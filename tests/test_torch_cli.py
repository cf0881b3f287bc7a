"""The port's command-line pipeline end to end on the CPU (``--device cpu``).

* The demo: ``cli.main --demo --train`` (2 epochs, T = 10), then ``--test``
  and ``--calib`` from its best checkpoint, ``--calib --cached_samples``,
  ``--export_predictor`` (the artifact loads in ``Predictor.load`` and
  predicts), ``--eval_guidance``. The demo learns: the best validation
  accuracy and the test's majority-vote accuracy pass the JAX runner
  test's bar for the separable demo data (> 60 %).
* The three stages on a tiny pathmnist.npz corpus: ``train_transformer``,
  ``train_mapping`` (all members, ``--mlp_idx``, ``--sequential``),
  ``assemble``, then ``main --train`` from the stage-1 checkpoints with
  ``--precompute_guidance --light_ckpt``, ``--test`` with ``--suite`` and
  ``--sweep`` on that checkpoint.
* Without CUDA each entry point that runs a model exits non-zero with a
  message unless it is given ``--device cpu``; ``--make_plots`` without
  matplotlib, and a non-ViT stage-1 checkpoint given to the mapping stage,
  exit with a message.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ladine_tpu_torch.cli import main as main_cli
from ladine_tpu_torch.cli import train_mapping, train_transformer
from ladine_tpu_torch.cli import assemble as assemble_cli
from ladine_tpu_torch.utils import load_checkpoint_meta

DIMS = ["--image_size", "16", "--patch_size", "8", "--embed_dim", "16", "--depth", "5", "--num_heads", "2"]
BAR = 60.0  # the JAX runner test's accuracy bar on the separable demo data


def _run(capsys, fn, argv):
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("demo"))
    assert main_cli.main(["--demo", "--train", "--device", "cpu", "--n_epochs", "2", "--timesteps", "10",
                          "--exp", exp, "--doc", "train", "--export_predictor"]) == 0
    return exp


def test_demo_train_test_calib(demo_run, capsys):
    exp = demo_run
    log = os.path.join(exp, "logs", "train")
    with open(os.path.join(log, "train_complete.json")) as f:
        done = json.load(f)
    assert done["best_accuracy"] > BAR and done["steps"] == 6
    ckpt = done["best_ckpt_path"]
    meta = load_checkpoint_meta(ckpt)
    assert meta["kind"] == "diffusion_members" and meta["ema_init"] == "zero"
    assert os.path.exists(os.path.join(log, "config.yml"))
    common = ["--demo", "--device", "cpu", "--timesteps", "10", "--exp", exp, "--diffusion_ckpt", ckpt,
              "--mc_trials", "4"]
    rep = _run(capsys, main_cli.main, common + ["--test", "--doc", "test", "--save_samples"])
    assert rep["mode"] == "test" and rep["num_samples"] == 20 and rep["num_instances"] == 210
    assert rep["majority_vote_accuracy"] > BAR
    dump = np.load(os.path.join(exp, "logs", "test", "samples.npz"))
    assert dump["samples"].shape == (20, 210, 2)
    cal = _run(capsys, main_cli.main, common + ["--calib", "--doc", "calib", "--tune_T"])
    assert cal["mode"] == "calib" and cal["calibrated_temperature"] > 0 and cal["nll_tuned_temperature"] > 0
    cached = _run(capsys, main_cli.main, ["--demo", "--device", "cpu", "--exp", exp, "--doc", "cached", "--calib",
                                          "--cached_samples", os.path.join(exp, "logs", "test", "samples.npz")])
    from ladine_tpu_torch.infer import temperature_search

    assert cached["calibrated_temperature"] == temperature_search(dump["samples"], dump["labels"])[0]
    ema = _run(capsys, main_cli.main, common + ["--test", "--doc", "ema", "--eval_ema"])
    assert ema["majority_vote_accuracy"] >= 0
    assert main_cli.main(["--demo", "--device", "cpu", "--test", "--tune_T", "--exp", exp]) == 2
    assert main_cli.main(["--demo", "--device", "cpu", "--exp", exp]) == 2


def test_demo_export_predictor_loads(demo_run):
    from ladine_tpu_torch.infer import Predictor

    pred = Predictor.load(os.path.join(demo_run, "logs", "train", "predictor_artifact"), device="cpu",
                          mc_trials=3, ddim_steps=4)
    images = np.random.default_rng(0).random((2, 16, 16, 3), dtype=np.float32)
    out = pred.predict(images, generator=torch.Generator().manual_seed(0))
    assert np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5)
    assert pred.model.members == 5 and pred.mc_trials == 3


def test_demo_eval_guidance(tmp_path, capsys):
    out = _run(capsys, main_cli.main, ["--demo", "--eval_guidance", "--device", "cpu", "--exp", str(tmp_path)])
    assert out["majority_vote_accuracy"] > BAR


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(6)
    z = {}
    for split, n in (("train", 16), ("val", 8), ("test", 6)):
        labels = rng.integers(0, 2, n)
        z[f"{split}_images"] = ((rng.random((n, 28, 28, 3)) * 0.2 + labels[:, None, None, None] * 0.6)
                                * 255).astype(np.uint8)
        z[f"{split}_labels"] = labels.reshape(-1, 1)
    np.savez(root / "pathmnist.npz", **z)
    return str(root)


def test_three_stages_then_test_suite_and_sweep(corpus, tmp_path, capsys):
    import yaml

    models = str(tmp_path / "models")
    data = ["--dataset", "PathMNIST", "--dataroot", corpus, "--device", "cpu", *DIMS, "--batch_size", "8"]
    vit = _run(capsys, train_transformer.main, data + ["--epochs", "1", "--out", models])
    assert vit["mode"] == "train_transformer" and np.isfinite(vit["last_loss"]) and vit["train_images"] == 16
    vit_ckpt = os.path.join(models, "vit_PathMNIST")
    assert load_checkpoint_meta(vit_ckpt)["kind"] == "vit"
    mlps = _run(capsys, train_mapping.main, data + ["--epochs", "1", "--out", models, "--vit_ckpt", vit_ckpt,
                                                     "--mlp_hidden_dims", "16", "8", "8"])
    assert len(mlps["best_val_accuracies"]) == 5
    mlp_dir = os.path.join(models, "PathMNIST", "MLPs")
    one = _run(capsys, train_mapping.main, data + ["--epochs", "1", "--out", str(tmp_path / "one"), "--vit_ckpt",
                                                    vit_ckpt, "--mlp_hidden_dims", "16", "8", "8", "--mlp_idx", "3"])
    assert one["mlp_idx"] == 3 and os.listdir(str(tmp_path / "one" / "PathMNIST" / "MLPs")) == ["block_3"]
    seq = _run(capsys, train_mapping.main, data + ["--epochs", "1", "--out", str(tmp_path / "one"), "--vit_ckpt",
                                                    vit_ckpt, "--mlp_hidden_dims", "16", "8", "8", "--sequential"])
    assert seq["sequential"] and seq["best_val_accuracies"][3] == one["best_val_accuracies"][0]  # block_3 kept
    with pytest.raises(SystemExit):
        train_mapping.main(data + ["--sequential", "--mlp_idx", "1"])
    guidance = str(tmp_path / "guidance")
    assert _run(capsys, assemble_cli.main, ["--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir", mlp_dir, "--out",
                                            guidance])["num_members"] == 5
    cfg = {"data": {"dataset": "PathMNIST", "dataroot": corpus, "num_classes": 2},
           "model": {"image_size": 16, "patch_size": 8, "embed_dim": 16, "vit_depth": 5, "num_heads": 2,
                     "mlp_hidden_dims": [16, 8, 8], "feature_dim": 16, "hidden_dim": 16, "data_dim": 768},
           "diffusion": {"timesteps": 10, "num_members": 5},
           "training": {"batch_size": 8, "n_epochs": 2, "warmup_epochs": 1, "validation_freq": 1},
           "testing": {"batch_size": 4, "mc_trials": 2, "drop_last": False}, "sampling": {"batch_size": 4}}
    cfg_path = str(tmp_path / "tiny.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    exp = str(tmp_path / "exp")
    common = ["--config", cfg_path, "--device", "cpu", "--exp", exp]
    tr = _run(capsys, main_cli.main, common + ["--train", "--doc", "train", "--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir",
                                               mlp_dir, "--precompute_guidance", "--light_ckpt", "--val_ddim", "3"])
    ckpt = tr["best_ckpt_path"]
    meta = load_checkpoint_meta(ckpt)
    assert meta["light"] and meta["guidance_src"]["mlp_dir"] == os.path.abspath(mlp_dir)
    snapshot = yaml.safe_load(open(os.path.join(exp, "logs", "train", "config.yml")))
    assert snapshot["diffusion"]["val_ddim_steps"] == 3 and snapshot["model"]["mlp_hidden_dims"] == [16, 8, 8]
    test = common + ["--test", "--diffusion_ckpt", ckpt, "--ddim", "3"]
    rep = _run(capsys, main_cli.main, test + ["--doc", "test"])
    assert rep["num_instances"] == 6 and rep["num_samples"] == 10
    suite = str(tmp_path / "suite.json")
    with open(suite, "w") as f:
        json.dump({"float": {}, "k4": {"use_int8_pallas": True},
                   "k5": {"use_int8_pallas": True, "pallas_fuse_ends": True}, "pgd": {"attack_name": "PGD"}}, f)
    res = _run(capsys, main_cli.main, test + ["--doc", "suite", "--suite", suite])
    assert sorted(res["rows"]) == ["float", "k4", "k5", "pgd"]
    assert all(os.path.exists(os.path.join(exp, "logs", "suite", f"report_{n}.json")) for n in res["rows"])
    sw = _run(capsys, main_cli.main, test + ["--doc", "sweep", "--sweep", "noise=0,0.1"])
    assert [r["noise"] for r in sw["rows"]] == [0.0, 0.1]
    assert main_cli.main(test + ["--doc", "sweep", "--sweep", "blur=1"]) == 2
    # evaluating random weights outside --demo is refused
    assert main_cli.main(common + ["--test", "--doc", "refused"]) == 2


@pytest.mark.parametrize("fn,argv", [
    (main_cli.main, ["--demo", "--train"]),
    (train_transformer.main, ["--demo"]),
    (train_mapping.main, ["--demo"]),
], ids=["main", "train_transformer", "train_mapping"])
def test_no_card_exits_with_a_message_unless_device_cpu(fn, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        fn(argv)
    assert "CUDA is not available" in str(e.value.code) and "--device cpu" in str(e.value.code)


def test_refusals_with_messages(tmp_path, monkeypatch):
    # every backbone trains in stage 1 (tests/test_torch_backbones_cli.py); the mapping stage takes the ViT only
    from ladine_tpu_torch.models.encoders import ResNet
    from ladine_tpu_torch.utils import save_checkpoint

    save_checkpoint(str(tmp_path / "resnet18_ChestXRay"), {"params": ResNet(2, "resnet18").state_dict()},
                    {"kind": "vit"})
    with pytest.raises(SystemExit, match="taps the ViT only"):
        train_mapping.main(["--demo", "--device", "cpu", "--epochs", "1", "--out", str(tmp_path),
                            "--vit_ckpt", str(tmp_path / "resnet18_ChestXRay")])
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it
    with pytest.raises(SystemExit, match="needs matplotlib"):
        main_cli.main(["--demo", "--test", "--device", "cpu", "--make_plots", "--exp", str(tmp_path)])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main_cli.main(["--demo", "--test", "--device", "cpu", "--bf16", "--fp32"])
