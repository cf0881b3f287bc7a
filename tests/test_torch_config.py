"""The port's config (``ladine_tpu_torch/config.py``) against the JAX
package's, and its YAML reader against PyYAML.

* ``Config()`` and ``Config.from_yaml`` of every file in ``configs/`` give
  the JAX package's ``to_dict()`` exactly.
* The port's own YAML reader equals ``yaml.safe_load`` on every file in
  ``configs/`` and on the scalar forms the subset takes (one departure: a
  dot-less exponent such as ``1e-4`` is a float, where PyYAML keeps a
  string); its writer's output reads back the same with both readers.
* The strict ``--set`` (``ROADMAP.md`` §3 D3), each case run through both
  packages' ``main``: an unknown section or leaf exits, a value is a float
  only where the field is, and ``--set data.seed`` wins over ``--seed``.
  The JAX ``main`` runs until it builds its ``Runner``, which the test
  replaces by one that hands back the config.
"""

import dataclasses
import glob
import os

import pytest
import yaml

import ladine_tpu.cli.runner as jax_runner
from ladine_tpu.cli.main import main as jax_main
from ladine_tpu.config import Config as JaxConfig
from ladine_tpu_torch.cli.main import build_config, build_parser
from ladine_tpu_torch.cli.main import main as torch_main
from ladine_tpu_torch.config import Config, dump_yaml, parse_scalar, parse_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


def test_defaults_equal_jax():
    assert Config().to_dict() == JaxConfig().to_dict()
    for jf, tf in zip(dataclasses.fields(JaxConfig), dataclasses.fields(Config)):
        assert jf.name == tf.name


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_from_yaml_equals_jax(path):
    assert Config.from_yaml(path).to_dict() == JaxConfig.from_yaml(path).to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_pyyaml_on_configs(path):
    text = open(path).read()
    assert parse_yaml(text) == yaml.safe_load(text)


SCALARS = ["1", "-3", "0", "010", "0x1F", "1_000", "1.5", "-0.25", ".5", "1.", "0.00000001", "1.0e-08",
           "-.inf", ".inf", "true", "True", "TRUE", "yes", "No", "off", "On", "null", "Null", "~", "",
           "abc", "ChestXRay", "tRue", "'quoted: #'", '"double"', "./data/x_y", "[1, 2]", "[0.001, 0.999]",
           "[[a, b], c]", "['a, b', 3]", "[]"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_rules_equal_pyyaml(text):
    assert parse_scalar(text) == yaml.safe_load(text) if text else parse_scalar(text) is None


def test_dotless_exponent_is_a_float():
    # the one departure: YAML 1.1 (PyYAML) keeps '1e-4' a string
    assert parse_scalar("1e-4") == 1e-4 and yaml.safe_load("1e-4") == "1e-4"


def test_block_lists_comments_and_nesting():
    text = """
# a comment
a:
  b: 1   # trailing comment
  c:
    - x
    - 2
  d: [1, [2, 3]]
e:
- 1.5
- 'q # not a comment'
f:
g: "s"
"""
    assert parse_yaml(text) == yaml.safe_load(text)


def test_save_load_roundtrip(tmp_path):
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "synthetic224.yml"))
    cfg.data.dataroot = "/data/set: one"  # a string that must be quoted
    cfg.optim.eps, cfg.optim.lowmem = 1e-8, True
    cfg.diffusion.trained_diffusion_ckpt_path = ["a", "b"]
    path = str(tmp_path / "cfg" / "config.yml")
    cfg.save_yaml(path)
    assert Config.from_yaml(path).to_dict() == cfg.to_dict()
    text = open(path).read()
    assert parse_yaml(text) == yaml.safe_load(text)
    assert JaxConfig.from_yaml(path).to_dict() == cfg.to_dict()  # the JAX package reads it too
    assert parse_yaml(dump_yaml({"s": {}})) == {"s": {}}


class _Captured(Exception):
    pass


def _jax_config(monkeypatch, argv):
    """The config the JAX ``main`` builds from ``argv`` (its Runner replaced
    by one that raises with it)."""

    class Capture:
        def __init__(self, cfg, **_):
            raise _Captured(cfg)

    monkeypatch.setattr(jax_runner, "Runner", Capture)
    with pytest.raises(_Captured) as e:
        jax_main(argv)
    return e.value.args[0]


def _torch_config(argv):
    return build_config(build_parser().parse_args(argv))


def test_set_unknown_leaf_exits_where_jax_ignores_it(monkeypatch, tmp_path):
    argv = ["--demo", "--set", "model.no_such_field=3", "--exp", str(tmp_path)]
    jcfg = _jax_config(monkeypatch, argv)
    assert not hasattr(jcfg.model, "no_such_field")  # the JAX main goes on without it
    with pytest.raises(SystemExit, match="no field 'no_such_field'"):
        torch_main(argv + ["--device", "cpu"])


def test_set_unknown_section_exits_where_jax_raises(monkeypatch, tmp_path):
    argv = ["--demo", "--set", "modle.dtype=bfloat16", "--exp", str(tmp_path)]
    monkeypatch.setattr(jax_runner, "Runner", None)
    with pytest.raises(AttributeError):  # a traceback from getattr, not a message
        jax_main(argv)
    with pytest.raises(SystemExit, match="no config section 'modle'"):
        torch_main(argv + ["--device", "cpu"])


def test_set_coerces_to_float_only_for_float_fields(monkeypatch):
    argv = ["--demo", "--set", "data.dataset=1e3", "--set", "optim.lr=5e-4", "--set", "optim.lowmem=true",
            "--set", "data.label_min_max=[0.01, 0.99]", "--set", "optim.grad_clip=2"]
    jcfg, tcfg = _jax_config(monkeypatch, argv), _torch_config(argv)
    assert jcfg.data.dataset == 1000.0  # the JAX float coercion turns a name into a number
    assert tcfg.data.dataset == "1e3"
    assert jcfg.optim.lr == tcfg.optim.lr == 5e-4 and isinstance(tcfg.optim.lr, float)
    assert jcfg.optim.lowmem is True and tcfg.optim.lowmem is True
    assert tcfg.data.label_min_max == (0.01, 0.99)
    assert tcfg.optim.grad_clip == 2.0 and isinstance(tcfg.optim.grad_clip, float)
    # an int field refuses a float where the JAX main stores one
    argv = ["--demo", "--set", "training.n_epochs=1e3"]
    assert _jax_config(monkeypatch, argv).training.n_epochs == 1000.0
    with pytest.raises(SystemExit, match="expected an integer"):
        _torch_config(argv)
    with pytest.raises(SystemExit, match="expected true or false"):
        _torch_config(["--set", "optim.lowmem=maybe"])


def test_set_data_seed_wins_over_seed(monkeypatch):
    argv = ["--demo", "--seed", "3", "--set", "data.seed=7"]
    assert _jax_config(monkeypatch, argv).data.seed == 3  # the JAX main applies --seed last
    assert _torch_config(argv).data.seed == 7
    assert _torch_config(["--seed", "3"]).data.seed == 3


def test_flags_build_the_jax_config(monkeypatch):
    argv = ["--config", os.path.join(REPO, "configs", "synthetic_tiny.yml"), "--timesteps", "20", "--ddim", "5",
            "--eta", "0.5", "--val_ddim", "3", "--skip_type", "quad", "--noise_prior", "--noise_prior_sample_only",
            "--bf16", "--mc_trials", "4", "--n_epochs", "2", "--dataroot", "/d", "--preprocess", "standardized",
            "--set", "optim.lowmem=true", "--set", "optim.lr=0.002"]
    assert _torch_config(argv).to_dict() == _jax_config(monkeypatch, argv).to_dict()
