"""``cli/train_transformer.py --demo`` for each of the seven
``--model_arch`` choices in both packages, on the CPU: the checkpoint is
named ``{arch}_{dataset}`` in both, and its tensors' names and shapes equal
the JAX checkpoint's through the bridge (``utils/convert.py``); a BatchNorm
backbone's also carries its ``batch_stats`` (``ROADMAP.md`` §3 D6). The
backbones' numerics against JAX: ``tests/test_torch_backbones.py``.
"""

import json
import os

import jax
import numpy as np
import pytest

from ladine_tpu_torch.utils import module_from_flax
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["vit", "deit", "deit_distilled", "convit", "efficientnetv2", "resnet18", "resnet50"]


@pytest.fixture(scope="module")
def jax_demo_runs(tmp_path_factory):
    """The JAX CLI's --demo for every arch, once (one epoch)."""
    from ladine_tpu.cli import train_transformer as jax_cli

    out = str(tmp_path_factory.mktemp("jax_stage1"))
    for arch in ARCHS:
        assert jax_cli.main(["--demo", "--cpu", "--epochs", "1", "--model_arch", arch, "--out", out]) == 0
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_transformer_demo_in_both_packages(arch, jax_demo_runs, tmp_path, capsys):
    from ladine_tpu.utils import load_checkpoint as jax_load
    from ladine_tpu_torch.cli import train_transformer
    from ladine_tpu_torch.utils import load_checkpoint

    assert train_transformer.main(["--demo", "--device", "cpu", "--epochs", "1", "--model_arch", arch,
                                   "--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "train_transformer" and np.isfinite(res["last_loss"]) and res["train_images"] == 32
    name = f"{arch}_ChestXRay"
    tree, meta = load_checkpoint(os.path.join(str(tmp_path), name))
    jtree, _ = jax_load(os.path.join(jax_demo_runs, name))
    want = module_from_flax({"params": jax.tree.map(np.asarray, jtree["params"])})
    assert {k: tuple(v.shape) for k, v in tree["params"].items()} == {k: tuple(v.shape) for k, v in want.items()}
    bn = arch in ("efficientnetv2", "resnet18", "resnet50")
    assert ("batch_stats" in tree) == bn and meta["kind"] == "vit"
