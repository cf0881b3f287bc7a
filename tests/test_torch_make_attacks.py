"""The port's ``cli/make_attacks.py`` against ``ladine_tpu/cli/make_attacks.py``
on the CPU: FGSM (eps 0.03) against the same demo-geometry ViT (weights
from a flax init, carried by ``utils/convert.py``) over a tiny ImageFolder
test split written here, in both packages. The two trees hold the same
files, and each PNG equals the other's to within one uint8 level (the
images are rounded to uint8 after float32 arithmetic that sums in other
orders). The port writes its PNGs through ``data/png.py``: without Pillow
it writes the same tree from PNGs at the target size, and exits non-zero
with a message, before it attacks anything, where the images need Pillow
to be resized.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ladine_tpu.cli import make_attacks as jax_cli
from ladine_tpu.models import ViT as JaxViT
from ladine_tpu.utils import save_checkpoint as jax_save
from ladine_tpu_torch.cli import make_attacks as port_cli
from ladine_tpu_torch.utils import save_checkpoint, vit_from_flax
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

IMG = 16


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """testing/{NORMAL,PNEUMONIA}/*.png (6 images, 16 x 16 RGB) and the ViT
    checkpoint in each package's format."""
    from PIL import Image

    root = tmp_path_factory.mktemp("attacks")
    rng = np.random.default_rng(0)
    for cls, n in (("NORMAL", 3), ("PNEUMONIA", 3)):
        d = root / "data" / "testing" / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.random((IMG, IMG, 3)) * 255).astype(np.uint8)).save(d / f"{i}.png")
    vit = JaxViT(num_classes=2, img_size=IMG, patch_size=8, embed_dim=16, depth=2, num_heads=2)
    params = jax.tree.map(np.asarray, vit.init(jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)))["params"])
    jax_save(str(root / "jax_vit"), {"params": params}, {"kind": "vit"})
    save_checkpoint(str(root / "port_vit"), {"params": vit_from_flax({"params": params})}, {"kind": "vit"})
    return root


def _pngs(out):
    from PIL import Image

    return {os.path.relpath(os.path.join(d, f), out): np.asarray(Image.open(os.path.join(d, f)), np.int16)
            for d, _, fs in os.walk(out) for f in fs}


def test_fgsm_trees_match_the_jax_cli(corpus, capsys):
    common = ["--dataroot", str(corpus / "data"), "--attack_name", "FGSM", "--epsilon", "0.03", "--demo",
              "--image_size", str(IMG), "--batch_size", "4"]
    assert jax_cli.main(common + ["--cpu", "--guidance_ckpt", str(corpus / "jax_vit"),
                                  "--out", str(corpus / "jax_out")]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_cli.main(common + ["--device", "cpu", "--guidance_ckpt", str(corpus / "port_vit"),
                                   "--out", str(corpus / "port_out")]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["images"] == theirs["images"] == 6
    assert ours["attack_success_rate"] == theirs["attack_success_rate"]
    got, want = _pngs(corpus / "port_out"), _pngs(corpus / "jax_out")
    assert sorted(got) == sorted(want) and len(got) == 6
    for name, img in want.items():
        assert got[name].shape == (IMG, IMG, 3)
        assert np.abs(got[name] - img).max() <= 1, name


def test_without_pillow_the_command_exits_with_a_message(corpus, monkeypatch):
    """Images stored at 16 px and attacked at 32 need Pillow's resize."""
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without Pillow
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--dataroot", str(corpus / "data"), "--attack_name", "FGSM", "--demo", "--device", "cpu",
                       "--image_size", str(2 * IMG), "--out", str(corpus / "never")])
    assert "Pillow" in str(e.value.code)
    assert not os.path.exists(corpus / "never")


def test_without_pillow_the_command_writes_the_same_tree(corpus, monkeypatch):
    """At the stored size the port reads and writes its PNGs without
    Pillow: the tree equals the one it writes with Pillow importable."""
    argv = ["--dataroot", str(corpus / "data"), "--attack_name", "FGSM", "--epsilon", "0.03", "--demo",
            "--image_size", str(IMG), "--batch_size", "4", "--device", "cpu",
            "--guidance_ckpt", str(corpus / "port_vit")]
    assert port_cli.main(argv + ["--out", str(corpus / "with_pil")]) == 0
    with_pil = _pngs(corpus / "with_pil")
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert port_cli.main(argv + ["--out", str(corpus / "without_pil")]) == 0
    monkeypatch.undo()
    without = _pngs(corpus / "without_pil")
    assert sorted(without) == sorted(with_pil) and len(without) == 6
    for name, img in with_pil.items():
        assert np.array_equal(without[name], img), name
