"""The port's ``utils/`` for the command-line pipeline against the JAX
package's: train-state checkpoints, guidance assembly, logging and plots.

* Train-state checkpoints (``save_train_state`` / ``load_train_state``)
  round-trip bit for bit, float32 and ``lowmem`` (bf16 moments and EMA),
  and in the light form (params, EMA, batch statistics and steps only,
  floats in the compute dtype); the debiased EMA read from a loaded
  checkpoint equals the read of the live state exactly.
* ``assemble_guidance`` of stage-1 checkpoints carried over from the JAX
  package's (the ViT's and each mapping MLP's flax trees, converted) equals
  the JAX package's assembled tree carried over, bit for bit; split and
  export invert it, and the assemble CLI round-trips both ways.
* ``ScalarLogger``'s JSONL lines have the JAX package's keys and values
  (``ts`` aside); ``setup_logging`` writes ``stdout.txt``; the plots render
  with matplotlib and fail with a message without it.
"""

import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladine_tpu.utils as JU
from ladine_tpu.models import MappingMLP as JaxMLP
from ladine_tpu.models import ViT as JaxViT
from ladine_tpu_torch.cli import assemble as assemble_cli
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, ViT
from ladine_tpu_torch.train import (
    create_member_states,
    create_vit_state,
    ema_params_from_ckpt,
    ema_read,
    make_optimizer,
)
from ladine_tpu_torch.utils import (
    ScalarLogger,
    assemble_guidance,
    device_memory_stats,
    export_guidance_stage1,
    guidance_from_flax,
    load_checkpoint,
    load_train_state,
    mlp_from_flax,
    save_checkpoint,
    save_train_state,
    setup_logging,
    split_guidance,
    trace,
    validate_guidance_tree,
    vit_from_flax,
)

G = dict(img=16, patch=8, embed=16, depth=5, heads=2, mlp=(16, 8, 8), members=5)


def _states(lowmem, members=3):
    model = ConditionalModel(members, 48, 16, 16, 2, 11, device="meta", dtype=torch.float32)
    tx = make_optimizer("Adam", 1e-3, lowmem=lowmem)
    state = create_member_states(model, torch.Generator().manual_seed(0), tx, members, lowmem=lowmem,
                                 device="cpu")
    g = torch.Generator().manual_seed(1)
    for d in (state.params, state.ema, state.opt_state["mu"], state.opt_state["nu"]):
        for v in d.values():
            v.copy_(torch.randn(v.shape, generator=g))
    state.step.copy_(torch.tensor([1, 5, 9][:members], dtype=torch.int32))
    state.opt_state["count"].copy_(state.step)
    return state


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("lowmem", [False, True], ids=["fp32", "lowmem"])
def test_member_train_state_roundtrip(tmp_path, lowmem):
    state = _states(lowmem)
    gvars = {"params": {"w": torch.randn(3, 2)}}
    meta = save_train_state(str(tmp_path / "ck"), state, {"epoch": 4, "kind": "diffusion_members"}, guidance=gvars)
    assert meta["ema_init"] == "zero" and meta["lowmem"] is lowmem and meta["light"] is False
    back, g, meta2 = load_train_state(str(tmp_path / "ck"))
    assert meta2 == meta and type(back).__name__ == "MemberTrainState"
    for f in ("params", "batch_stats", "opt_state", "ema"):
        _assert_tree_equal(getattr(back, f), getattr(state, f))
    assert torch.equal(back.step, state.step)
    _assert_tree_equal(g, gvars)
    if lowmem:
        w = "lin2.linear.weight"
        assert back.ema[w].dtype == back.opt_state["mu"][w].dtype == torch.bfloat16
    # the debiased read from the checkpoint is the live state's
    tree, _ = load_checkpoint(str(tmp_path / "ck"))
    _assert_tree_equal(ema_params_from_ckpt(tree["states"], {**meta, "ema_rate": 0.999}),
                       ema_read(state.ema, 0.999, state.step, "zero"))


def test_light_train_state_keeps_the_eval_payload_in_the_compute_dtype(tmp_path):
    state = _states(False)
    save_train_state(str(tmp_path / "ck"), state, {"kind": "diffusion_members"}, light=True,
                     light_dtype=torch.bfloat16)
    st, g, meta = load_train_state(str(tmp_path / "ck"))
    assert meta["light"] is True and g is None and sorted(st) == ["batch_stats", "ema", "params", "step"]
    assert all(v.dtype == torch.bfloat16 for v in st["params"].values())
    assert all(v.dtype == torch.float32 for v in st["batch_stats"].values())
    _assert_tree_equal(st["params"], {k: v.to(torch.bfloat16) for k, v in state.params.items()})
    assert torch.equal(st["step"], state.step)
    # only diffusion-member states (they carry an EMA) have a light form
    with pytest.raises(ValueError, match="light"):
        save_train_state(str(tmp_path / "vit"), _vit_state(), light=True)


def _vit_state():
    vit = ViT(2, G["img"], G["patch"], G["embed"], 2, G["heads"], device="meta", dtype=torch.float32)
    return create_vit_state(vit, torch.Generator().manual_seed(0), make_optimizer("AdamW", 1e-4, 0.1),
                            device="cpu")


def test_vit_train_state_roundtrip(tmp_path):
    state = _vit_state()
    meta = save_train_state(str(tmp_path / "vit"), state, {"kind": "vit"})
    assert "ema_init" not in meta
    back, _, _ = load_train_state(str(tmp_path / "vit"))
    assert type(back).__name__ == "TrainState"
    _assert_tree_equal(back.params, state.params)
    _assert_tree_equal(back.opt_state, state.opt_state)


@pytest.fixture(scope="module")
def jax_stage1(tmp_path_factory):
    """JAX stage-1 checkpoints (orbax) and the port's, carried over part by
    part: ``{jax,torch}/vit_ChestXRay`` + ``{jax,torch}/ChestXRay/MLPs/block_k``."""
    root = tmp_path_factory.mktemp("stage1")
    vit = JaxViT(num_classes=2, img_size=G["img"], patch_size=G["patch"], embed_dim=G["embed"], depth=G["depth"],
                 num_heads=G["heads"])
    vparams = vit.init(jax.random.PRNGKey(0), jnp.zeros((1, G["img"], G["img"], 3)))["params"]
    mlp = JaxMLP(num_classes=2, hidden_dims=G["mlp"])
    n_patches = (G["img"] // G["patch"]) ** 2
    for side in ("jax", "torch"):
        (root / side).mkdir()
    JU.save_checkpoint(str(root / "jax" / "vit_ChestXRay"), {"params": vparams}, {"kind": "vit"})
    save_checkpoint(str(root / "torch" / "vit_ChestXRay"), {"params": vit_from_flax({"params": vparams})},
                    {"kind": "vit"})
    for k in range(G["members"]):
        mp = mlp.init(jax.random.PRNGKey(10 + k), jnp.zeros((1, n_patches, G["embed"])))["params"]
        JU.save_checkpoint(str(root / "jax" / "ChestXRay" / "MLPs" / f"block_{k}"), {"params": mp},
                           {"member": k, "kind": "mapping_mlp"})
        save_checkpoint(str(root / "torch" / "ChestXRay" / "MLPs" / f"block_{k}"),
                        {"params": mlp_from_flax({"params": mp})}, {"member": k, "kind": "mapping_mlp"})
    return root


def _template():
    return SEViTGuidance(2, G["members"], G["depth"], G["img"], G["patch"], G["embed"], G["heads"], G["mlp"],
                         device="meta", dtype=torch.float32).state_dict()


def test_assemble_equals_jax_assembled_tree(jax_stage1):
    want = guidance_from_flax(JU.assemble_guidance(str(jax_stage1 / "jax" / "vit_ChestXRay"),
                                                   mlp_dir=str(jax_stage1 / "jax" / "ChestXRay" / "MLPs")))
    got = assemble_guidance(str(jax_stage1 / "torch" / "vit_ChestXRay"),
                            mlp_dir=str(jax_stage1 / "torch" / "ChestXRay" / "MLPs"), num_members=G["members"])
    _assert_tree_equal(got["params"], want)
    checked = validate_guidance_tree(got, _template())
    SEViTGuidance(2, G["members"], G["depth"], G["img"], G["patch"], G["embed"], G["heads"], G["mlp"],
                  device="cpu").load_state_dict(checked["params"])
    with pytest.raises(ValueError, match="expected 4"):
        assemble_guidance(str(jax_stage1 / "torch" / "vit_ChestXRay"),
                          mlp_dir=str(jax_stage1 / "torch" / "ChestXRay" / "MLPs"), num_members=4)
    with pytest.raises(ValueError, match="member 1, expected 0"):
        assemble_guidance(str(jax_stage1 / "torch" / "vit_ChestXRay"),
                          mlp_ckpts=[str(jax_stage1 / "torch" / "ChestXRay" / "MLPs" / "block_1")])


def test_validate_names_the_offender(jax_stage1):
    tree = assemble_guidance(str(jax_stage1 / "torch" / "vit_ChestXRay"),
                             mlp_dir=str(jax_stage1 / "torch" / "ChestXRay" / "MLPs"))
    wrong = SEViTGuidance(2, G["members"], G["depth"], G["img"], G["patch"], 32, G["heads"], G["mlp"],
                          device="meta").state_dict()
    with pytest.raises(ValueError, match=r"at mlps.0.layers.0.weight: checkpoint \(16, 64\) vs model \(16, 128"):
        validate_guidance_tree(tree, wrong)
    fewer = SEViTGuidance(2, 4, G["depth"], G["img"], G["patch"], G["embed"], G["heads"], G["mlp"],
                          device="meta").state_dict()
    with pytest.raises(ValueError, match="extra=.*mlps.4"):
        validate_guidance_tree(tree, fewer)


def test_split_export_and_the_cli_roundtrip(jax_stage1, tmp_path, capsys):
    vit_ckpt = str(jax_stage1 / "torch" / "vit_ChestXRay")
    mlp_dir = str(jax_stage1 / "torch" / "ChestXRay" / "MLPs")
    tree = assemble_guidance(vit_ckpt, mlp_dir=mlp_dir)
    vit_tree, mlps = split_guidance(tree)
    assert len(mlps) == G["members"]
    _assert_tree_equal(vit_tree["params"], load_checkpoint(vit_ckpt)[0]["params"])
    paths = export_guidance_stage1(tree, str(tmp_path / "exported"), "ChestXRay")
    assert len(paths) == 1 + G["members"]
    _assert_tree_equal(assemble_guidance(paths[0], mlp_ckpts=paths[1:])["params"], tree["params"])
    out = str(tmp_path / "guidance")
    assert assemble_cli.main(["--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir", mlp_dir, "--out", out]) == 0
    assert json.loads(capsys.readouterr().out)["num_members"] == G["members"]
    _assert_tree_equal(load_checkpoint(out)[0]["params"], tree["params"])
    assert assemble_cli.main(["--split", out, "--dataset", "X", "--out", str(tmp_path / "back")]) == 0
    _assert_tree_equal(load_checkpoint(str(tmp_path / "back" / "X" / "MLPs" / "block_3"))[0], mlps[3])
    with pytest.raises(SystemExit, match="--vit_ckpt is required"):
        assemble_cli.main(["--out", out])


def test_scalar_logger_lines_match_jax(tmp_path):
    for side, cls in (("jax", JU.ScalarLogger), ("torch", ScalarLogger)):
        log = cls(str(tmp_path / side), use_tensorboard=False)
        log.add_scalar("loss/mean", np.float32(0.25), 3)
        log.add_scalar("accuracy", 87.5, np.int64(10))
        log.close()
    lines = {side: [json.loads(l) for l in open(tmp_path / side / "scalars.jsonl")] for side in ("jax", "torch")}
    for a, b in zip(lines["jax"], lines["torch"]):
        assert sorted(a) == sorted(b) == ["step", "tag", "ts", "value"]
        assert {k: v for k, v in a.items() if k != "ts"} == {k: v for k, v in b.items() if k != "ts"}
    assert len(lines["torch"]) == 2


def test_setup_logging_writes_stdout_txt(tmp_path):
    logger = setup_logging(str(tmp_path))
    logger.info("hello from the port")
    for h in logger.handlers:
        h.flush()
    assert "hello from the port" in open(tmp_path / "stdout.txt").read()
    assert logger.name == "ladine_tpu_torch"
    setup_logging(None)  # closes the file handler


def test_memory_stats_and_trace_on_the_cpu(tmp_path):
    assert device_memory_stats() == {}
    with trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")


def _report():
    from ladine_tpu_torch.infer import compute_report

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 30)
    samples = (np.eye(2)[labels][None] + rng.normal(scale=0.3, size=(8, 30, 2))).astype(np.float32)
    return compute_report(samples, labels, 0.2)


def test_plots_render_and_need_matplotlib(tmp_path, monkeypatch):
    from ladine_tpu_torch.utils.plots import save_evaluation_plots

    paths = save_evaluation_plots(_report(), str(tmp_path))
    assert sorted(os.path.basename(p) for p in paths) == ["piw_per_class.png", "qq_mc_differences.png",
                                                          "reliability.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        save_evaluation_plots(_report(), str(tmp_path / "none"))
    logging.getLogger("ladine_tpu_torch").handlers.clear()
