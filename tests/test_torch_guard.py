"""The port stands alone and never hides the card.

* No module of ladine_tpu_torch, and not chip_smoke.py, imports jax, flax,
  optax, orbax or the JAX package. The check reads the source (AST), not
  ``sys.modules``: jax may already be imported by the interpreter's startup.
* None imports PyYAML (the card machine has none: the config reads and
  writes its YAML itself), and PIL and matplotlib (absent there too) are
  imported only inside the functions that decode an image or draw a plot.
* Entry points run on the card by default and raise without CUDA, unless the
  caller passes ``device="cpu"``: the models, the schedule, the predictor,
  the trainers' state makers, the hand-off from training to serving and
  the GMM posterior check.
"""

import ast
import pathlib

import pytest
import torch

from ladine_tpu_torch.cli.runner import Runner
from ladine_tpu_torch.config import Config
from ladine_tpu_torch.examples.gmm_posterior import run as gmm_run
from ladine_tpu_torch.infer import Predictor
from ladine_tpu_torch.models import ConditionalModel, MappingMLP, SEViTGuidance, ViT
from ladine_tpu_torch.ops import DiffusionSchedule
from ladine_tpu_torch.train import (
    conditional_model_from_state,
    create_mapping_states,
    create_member_states,
    create_vit_state,
    make_optimizer,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ladine_tpu"}


def _sources():
    files = sorted((ROOT / "ladine_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


@pytest.mark.parametrize("package", ["train", "data", "examples", "models", "kernels", "infer", "utils", "cli",
                                     "parallel"])
def test_guard_reads_every_subpackage(package):
    """The training, data, example and command-line subpackages are read
    like the rest."""
    read = {p.relative_to(ROOT / "ladine_tpu_torch").parts[0] for p in _sources()[:-1]}
    assert package in read
    assert all(p in _sources() for p in (ROOT / "ladine_tpu_torch" / package).glob("*.py"))


def _top_level_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


# optional packages the card machine lacks: where the port may import each
OPTIONAL = {"yaml": set(), "PIL": {"data/imagefolder.py"}, "matplotlib": {"utils/plots.py"}}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_only_inside_their_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    module_level = {n for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
                    for n in _top_level_imports_of(node)}
    anywhere = set(_top_level_imports(path))
    rel = str(path.relative_to(ROOT / "ladine_tpu_torch")) if "ladine_tpu_torch" in path.parts else path.name
    for name, allowed in OPTIONAL.items():
        assert name not in module_level, f"{path} imports {name} at module level"
        assert name not in anywhere or rel in allowed, f"{path} imports {name}"


def _top_level_imports_of(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    return [node.module.split(".")[0]] if node.level == 0 else []


def test_guard_checks_the_top_level_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import ladine_tpu_torch.ops\nfrom ladine_tpu.ops import schedules\n")
    assert list(_top_level_imports(probe)) == ["ladine_tpu_torch", "ladine_tpu"]


ENTRY_POINTS = {
    "schedule": lambda **kw: DiffusionSchedule.create("linear", 10, **kw),
    "vit": lambda **kw: ViT(img_size=16, patch_size=8, embed_dim=16, depth=1, num_heads=2, **kw),
    "mlp": lambda **kw: MappingMLP(in_dim=8, hidden_dims=(4,), **kw),
    "guidance": lambda **kw: SEViTGuidance(num_members=1, vit_depth=1, img_size=16, patch_size=8,
                                           embed_dim=16, num_heads=2, mlp_hidden_dims=(4,), **kw),
    "members": lambda **kw: ConditionalModel(2, 12, 4, 4, 2, 11, **kw),
    "member_states": lambda **kw: create_member_states(
        ConditionalModel(2, 12, 4, 4, 2, 11, device="meta"), torch.Generator(), make_optimizer(), 2, **kw),
    "vit_state": lambda **kw: create_vit_state(
        ViT(img_size=16, patch_size=8, embed_dim=16, depth=1, num_heads=2, device="meta"), torch.Generator(),
        make_optimizer(), **kw),
    "mapping_states": lambda **kw: create_mapping_states(
        MappingMLP(in_dim=8, hidden_dims=(4,), device="meta"), torch.Generator(), make_optimizer(), 2, **kw),
    "hand_off": lambda **kw: conditional_model_from_state(
        create_member_states(ConditionalModel(2, 12, 4, 4, 2, 11, device="meta"), torch.Generator(),
                             make_optimizer(), 2, device="cpu"), **kw),
    "gmm_posterior": lambda **kw: gmm_run(n_train_steps=1, mc_trials=1, verbose=False, **kw),
    "runner": lambda **kw: Runner(Config(), log_dir=None, demo=True, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda_unless_asked_for_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
    ENTRY_POINTS[name](device="cpu")


def test_predictor_raises_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = dict(
        guidance=ENTRY_POINTS["guidance"](device="cpu"),
        model=ENTRY_POINTS["members"](device="cpu"),
        sched=DiffusionSchedule.create("linear", 10, device="cpu"),
        head_indices=(0, 1),
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(**parts)
    assert Predictor(**parts, device="cpu").device.type == "cpu"


def test_a_cuda_device_turns_tf32_off(monkeypatch):
    """Resolving a card turns off the TF32 that torch lets cuDNN's
    convolutions use by default, so the conv backbones and encoders compute
    in float32 as documented (the flags are set, no card is touched)."""
    from ladine_tpu_torch.device import cli_device, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for resolve in (resolve_device, cli_device):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        assert resolve("cuda").type == "cuda"
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu" and torch.backends.cudnn.allow_tf32
