"""Typed configuration: the JAX package's dataclass tree, field for field.

Counterpart of ``ladine_tpu/config.py``. Section and field names mirror the
reference YAML, so ``Config.from_yaml`` reads the reference's files and the
repo's ``configs/`` as they are; unknown keys in a file are ignored, as
there.

The port reads and writes YAML with its own code (:func:`parse_yaml`,
:func:`dump_yaml`), no PyYAML: the subset the configs use. That is block
mappings nested by indentation, block lists (``- item``), flow lists
(``[a, b]``, nested), comments, and scalars: null (``~``, ``null``, empty),
booleans (YAML 1.1's ``true``/``yes``/``on`` and their negatives), ints
(decimal, ``0x`` hex, ``0``-led octal), floats (``1.5``, ``.5``, ``.inf``, ``.nan``, and
``1e-4``), and plain or quoted strings. One departure from PyYAML: a
dot-less exponent (``1e-4``) is a float, as YAML 1.2 reads it, where PyYAML
keeps a string.

CLI overrides (:meth:`Config.apply_cli_overrides`, ``--set``) are strict,
unlike the JAX package's (``ROADMAP.md`` §3 D3): an unknown section or leaf
raises ``SystemExit``, and a value becomes a float only where the field is
a float.
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


@dataclass
class DataConfig:
    dataset: str = "ChestXRay"
    seed: int = 4444
    label_min_max: Tuple[float, float] = (0.001, 0.999)
    num_classes: int = 2
    num_workers: int = 4
    dataroot: str = "PATH"
    preprocess: str = "grayscaled"  # grayscaled | standardized (CLI --preprocess)


@dataclass
class ModelConfig:
    data_dim: int = 150528  # 224*224*3
    feature_dim: int = 4096
    hidden_dim: int = 4096
    arch: str = "linear"
    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    vit_depth: int = 12
    num_heads: int = 12
    mlp_hidden_dims: Tuple[int, ...] = (4096, 2048, 128)
    var_type: str = "fixedlarge"
    ema_rate: float = 0.9999
    ema: bool = True
    dtype: str = "float32"  # or "bfloat16"
    use_pallas: bool = False  # the JAX package's Pallas attention; the port's ViT always runs K3
    fsdp: bool = False  # on a mesh (parallel/): shard the train state's large leaves over the data axis too


@dataclass
class DiffusionConfig:
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    timesteps: int = 1000
    include_guidance: bool = True
    apply_aux_cls: bool = True
    trained_aux_cls_ckpt_path: str = "./data/classification/pretrained/chest_x_ray_ckpt"
    trained_diffusion_ckpt_path: List[str] = field(default_factory=list)
    aux_cls_arch: str = "sevit"
    num_members: int = 5
    # zero prior mean at T instead of the guidance prediction (reference
    # --noise_prior), in sampling and, with noise_prior_training, training
    noise_prior: bool = False
    noise_prior_training: bool = True
    ddim_steps: int = 0  # strided sampler steps (0 = the full ancestral chain)
    ddim_eta: float = 1.0
    val_ddim_steps: int = 0  # the validation sampler's stride during training (0 = ddim_steps)
    skip_type: str = "uniform"  # uniform | quad


@dataclass
class TrainingConfig:
    batch_size: int = 30
    n_epochs: int = 1000
    warmup_epochs: int = 40
    snapshot_freq: int = 1_000_000_000
    logging_freq: int = 1200
    validation_freq: int = 10


@dataclass
class SamplingConfig:
    batch_size: int = 30
    last_only: bool = True


@dataclass
class TestingConfig:
    batch_size: int = 70
    n_samples: int = 100  # total MC samples = members * trials
    mc_trials: int = 20
    n_bins: int = 10
    PICP_range: Tuple[float, float] = (2.5, 97.5)
    drop_last: bool = True  # reference test loaders drop the tail batch


@dataclass
class OptimConfig:
    weight_decay: float = 0.0
    optimizer: str = "Adam"
    lr: float = 1e-3
    beta1: float = 0.9
    amsgrad: bool = False
    eps: float = 1e-8
    grad_clip: float = 1.0
    lr_schedule: bool = True
    min_lr: float = 0.0
    lowmem: bool = False  # bf16 Adam moments and EMA with stochastic rounding (train/lowmem.py)


@dataclass
class AuxConfig:
    """Stage-1 trainer settings."""

    vit_lr: float = 1e-4
    vit_weight_decay: float = 0.1
    vit_epochs: int = 200
    vit_step_size: int = 10
    vit_gamma: float = 0.5
    mlp_lr: float = 1e-3
    mlp_epochs: int = 301
    mlp_step_size: int = 20
    mlp_gamma: float = 0.5


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    testing: TestingConfig = field(default_factory=TestingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    aux_optim: OptimConfig = field(default_factory=OptimConfig)
    aux: AuxConfig = field(default_factory=AuxConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        for section, values in d.items():
            if not hasattr(cfg, section) or not isinstance(values, dict):
                continue
            sub = getattr(cfg, section)
            for k, v in values.items():
                _assign(sub, k, v)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(parse_yaml(f.read()) or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save_yaml(self, path: str) -> None:
        """The config snapshot a run writes into its log directory."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(dump_yaml(self.to_dict()))

    def apply_overrides(self, overrides: Dict[str, Any]) -> "Config":
        """Dotted-path overrides with already-typed values, e.g.
        ``{"diffusion.timesteps": 50}``, assigned as a YAML file's keys are."""
        for path, value in overrides.items():
            obj = self
            *parents, leaf = path.split(".")
            for p in parents:
                obj = getattr(obj, p)
            _assign(obj, leaf, value)
        return self

    def apply_cli_overrides(self, pairs: List[str]) -> "Config":
        """``--set section.key=value`` strings, strictly: the section and the
        leaf must exist (else ``SystemExit``), and the value, read by the
        YAML scalar rules, must fit the field's type. It becomes a float
        only where the field is a float; a string field keeps the text as
        written."""
        for s in pairs:
            if "=" not in s:
                raise SystemExit(f"--set expects section.key=value, got {s!r}")
            path, text = s.split("=", 1)
            parts = path.split(".")
            if len(parts) != 2:
                raise SystemExit(f"--set takes section.key=value, got {s!r}")
            section, leaf = parts
            sub = getattr(self, section, None)
            if not dataclasses.is_dataclass(sub):
                names = [f.name for f in dataclasses.fields(self)]
                raise SystemExit(f"--set {s!r}: no config section {section!r} (one of {names})")
            fields = {f.name: f for f in dataclasses.fields(sub)}
            if leaf not in fields:
                raise SystemExit(f"--set {s!r}: section {section!r} has no field {leaf!r} "
                                 f"(one of {sorted(fields)})")
            hint = typing.get_type_hints(type(sub))[leaf]
            try:
                value = _coerce(hint, parse_scalar(text), text)
            except ValueError as e:
                raise SystemExit(f"--set {s!r}: {e}") from None
            setattr(sub, leaf, value)
        return self


def _coerce(hint, value, text: str):
    """``value`` (read from ``text``) as the field type ``hint``."""
    origin = typing.get_origin(hint)
    if origin in (tuple, list):
        if not isinstance(value, list):
            raise ValueError(f"expected a list [a, b, ...], got {text!r}")
        args = [a for a in typing.get_args(hint) if a is not Ellipsis]
        items = [_coerce(args[min(i, len(args) - 1)], v, str(v)) for i, v in enumerate(value)]
        return tuple(items) if origin is tuple else items
    if hint is bool:
        if not isinstance(value, bool):
            raise ValueError(f"expected true or false, got {text!r}")
        return value
    if hint is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"expected an integer, got {text!r}")
        return value
    if hint is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"expected a number, got {text!r}")
        return float(value)
    if hint is str:
        return value if isinstance(value, str) else _unquote(text.strip())
    return value


def _assign(obj: Any, key: str, value: Any) -> None:
    # the reference YAML's keys that have no field here are ignored, as are
    # unknown keys; aux_cls.arch nests
    if key == "aux_cls" and isinstance(value, dict):
        if "arch" in value and hasattr(obj, "aux_cls_arch"):
            obj.aux_cls_arch = value["arch"]
        return
    if not hasattr(obj, key):
        return
    current = getattr(obj, key)
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        value = tuple(value)
    if isinstance(value, list) and value and isinstance(value[0], list):
        value = value[0]  # the reference nests ckpt path lists one level deep
    setattr(obj, key, value)


# ----------------------------------------------------------------- YAML subset

_BOOL = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_OCT = re.compile(r"^[-+]?0[0-7_]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9_]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")


def _unquote(s: str) -> str:
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return bytes(s[1:-1], "utf-8").decode("unicode_escape")
    return s


def parse_scalar(text: str) -> Any:
    """One value by the rules above; a flow list ``[a, b]`` reads as a list."""
    s = text.strip()
    if s.startswith("["):
        return _flow_list(s)
    if s == "{}":
        return {}
    if s[:1] in ("'", '"'):
        return _unquote(s)
    cased = s in (s.lower(), s.capitalize(), s.upper())  # YAML 1.1: null, Null, NULL
    if s in ("", "~") or (s.lower() == "null" and cased):
        return None
    if s.lower() in _BOOL and cased:
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _HEX.match(s):
        return int(s.replace("_", ""), 16)
    if _OCT.match(s):
        return int(s.replace("_", ""), 8)
    if _FLOAT.match(s) and any(ch.isdigit() for ch in s):
        return float(s.replace("_", ""))
    low = s.lower()
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    return s


def _flow_list(s: str) -> list:
    """``[a, [b, c], 'd, e']`` -> a list (nested lists and quoted items)."""

    def items(i):  # s[i] == "[": the list and the index after its "]"
        out, cur, i = [], "", i + 1
        while i < len(s):
            ch = s[i]
            if ch in ("'", '"'):
                j = s.index(ch, i + 1)
                cur, i = cur + s[i:j + 1], j + 1
                continue
            if ch == "[":
                sub, i = items(i)
                out.append(sub)
                cur = ""
                continue
            if ch in (",", "]"):
                if cur.strip():
                    out.append(parse_scalar(cur))
                cur = ""
                if ch == "]":
                    return out, i + 1
            else:
                cur += ch
            i += 1
        raise ValueError(f"unterminated flow list: {s!r}")

    value, end = items(0)
    if s[end:].strip():
        raise ValueError(f"text after a flow list: {s!r}")
    return value


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (outside quotes, after a space or at
    the start)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Any:
    """A YAML document of the subset above -> nested dicts, lists and
    scalars (None for an empty document)."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip() and line.strip() != "---":
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"cannot read YAML line {lines[end][1]!r}")
    return value


def _block(lines, i, indent):
    """The block node starting at ``lines[i]`` at ``indent``: a mapping or a
    list. Returns (value, next line index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent and (lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][1:].strip()
            i += 1
            if rest:
                out.append(parse_scalar(rest))
            elif i < len(lines) and lines[i][0] > indent:
                v, i = _block(lines, i, lines[i][0])
                out.append(v)
            else:
                out.append(None)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        key, sep, rest = _split_key(content)
        if not sep:
            raise ValueError(f"expected 'key: value', got {content!r}")
        i += 1
        if rest.strip():
            out[key] = parse_scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or
                                 (lines[i][0] == indent and lines[i][1].startswith("- "))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _split_key(content: str):
    quote = None
    for j, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == ":" and (j + 1 == len(content) or content[j + 1] == " "):
            return _unquote(content[:j].strip()), ":", content[j + 1:]
    return content, "", ""


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:  # 1e-08 -> 1.0e-08, a float to PyYAML as well
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    s = str(v)
    if s == "" or s != s.strip() or parse_scalar(s) != s or any(c in s for c in ":#[]{},&*!|>'\"%@`"):
        return "'" + s.replace("'", "''") + "'"
    return s


def dump_yaml(d: Dict[str, Any], indent: int = 0) -> str:
    """Nested dicts of scalars and lists as block mappings; lists flow."""
    out = []
    for k, v in d.items():
        pad = " " * indent
        if isinstance(v, dict):
            out.append(f"{pad}{k}:" + (" {}" if not v else ""))
            if v:
                out.append(dump_yaml(v, indent + 2).rstrip("\n"))
        else:
            out.append(f"{pad}{k}: {_dump_scalar(v)}")
    return "\n".join(out) + "\n"
