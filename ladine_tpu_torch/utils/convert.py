"""Weight bridge between the JAX package's flax variable trees and the
port's modules.

Flax trees are nested dicts of numpy arrays. Layouts: a flax Dense
``kernel`` is (in, out) and a torch ``nn.Linear`` weight (out, in); a flax
Conv ``kernel`` is (kh, kw, in, out) and a torch Conv2d weight
(out, in, kh, kw); LayerNorm and BatchNorm keep ``scale``/``bias`` in
``params`` and BatchNorm its ``mean``/``var`` in ``batch_stats``; a
timestep gate ``embed`` is (n_steps, N). The port's stacked members keep the
flax Dense layout with a leading member axis, so their tensors copy over
as they are.

    guidance.load_state_dict(guidance_from_flax(guidance_vars))
    model.load_state_dict(members_from_flax(stacked_vars))

The encoders and backbones (``models/encoders.py``, ``models/backbones.py``)
carry flax's own submodule names, so :func:`module_from_flax` and
:func:`module_to_flax` walk the names: a ``Dense_0`` (``TorchLinear``) or
``Conv_0`` (``TorchConv``) level is dropped, ``block{i}`` becomes
``blocks.{i}``, ``scale`` is ``weight``, and ``batch_stats``'
``mean``/``var`` are ``running_mean``/``running_var``. A conv arch's
stacked ``encoder_x`` goes the same way with its member axis in front.

Train states (``member_state_from_jax``, ``train_state_from_jax``) carry
over with their optimizer state (optax's ``mu``/``nu``/``trace`` and
count), EMA, BatchNorm statistics and step, so both frameworks can continue
one run.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# (port key, flax path, layout change); the change is None (copy),
# "T" (swap the last two axes) or "conv" (flax conv -> torch conv)
_Entry = Tuple[str, Tuple[str, ...], Optional[str]]


def _dense(port: str, path: Tuple[str, ...], layout: Optional[str] = "T") -> List[_Entry]:
    return [(f"{port}.weight", path + ("kernel",), layout), (f"{port}.bias", path + ("bias",), None)]


def _norm(port: str, path: Tuple[str, ...]) -> List[_Entry]:
    return [(f"{port}.weight", path + ("scale",), None), (f"{port}.bias", path + ("bias",), None)]


def _mlp_table(n_layers: int, port: str = "", path: Tuple[str, ...] = ("params",)) -> List[_Entry]:
    table: List[_Entry] = []
    for j in range(n_layers):
        table += _dense(f"{port}layers.{j}", path + (f"linear{j + 1}", "Dense_0"))
    return table


def _guidance_table(params: Dict[str, Any]) -> List[_Entry]:
    table = _walk_from_flax({"params": params}, port="vit.", sub=("vit",))
    for i in range(sum(k.startswith("mlp") for k in params)):
        table += _mlp_table(len(params[f"mlp{i}"]), f"mlps.{i}.", ("params", f"mlp{i}"))
    return table


def _members_table(encoder: List[_Entry] = ()) -> List[_Entry]:
    """The stacked members' entries: the linear arch's encoder layers, or
    ``encoder`` (a conv arch's walked ``encoder_x``), then the y-branch."""
    table: List[_Entry] = list(encoder)
    linear = ("enc_lin1", "enc_lin2", "enc_lin3") if not encoder else ()
    for name in linear + ("lin4",):
        table += _dense(name, ("params", name, "Dense_0"), layout=None)
    norms = ("enc_bn1", "enc_bn2") if not encoder else ()
    for name in norms + ("norm", "unetnorm1", "unetnorm2", "unetnorm3"):
        table += _norm(name, ("params", name))
        table += [(f"{name}.running_mean", ("batch_stats", name, "mean"), None),
                  (f"{name}.running_var", ("batch_stats", name, "var"), None)]
    for name in ("lin1", "lin2", "lin3"):
        table += _dense(f"{name}.linear", ("params", name, "TorchLinear_0", "Dense_0"), layout=None)
        table.append((f"{name}.embed", ("params", name, "embed"), None))
    return table


def _to_port(a: np.ndarray, layout: Optional[str]) -> np.ndarray:
    """flax -> torch layout; leading (member) axes stay in front."""
    if layout == "T":
        return np.swapaxes(a, -1, -2)
    if layout == "conv":  # (..., kh, kw, in, out) -> (..., out, in, kh, kw)
        n = a.ndim
        return np.transpose(a, tuple(range(n - 4)) + (n - 1, n - 2, n - 4, n - 3))
    return a


def _to_flax(a: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return np.swapaxes(a, -1, -2)
    if layout == "conv":  # (..., out, in, kh, kw) -> (..., kh, kw, in, out)
        n = a.ndim
        return np.transpose(a, tuple(range(n - 4)) + (n - 2, n - 1, n - 3, n - 4))
    return a


# ------------------------------------------------ the walk of flax's names

_BLOCK = re.compile(r"block(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()):
    if isinstance(tree, Mapping):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _port_name(segs) -> str:
    out = []
    for seg in segs:
        hit = _BLOCK.match(seg)
        out += ["blocks", hit.group(1)] if hit else [seg]
    return ".".join(out)


def _walk_from_flax(variables, lead: int = 0, port: str = "", sub: Tuple[str, ...] = ()) -> List[_Entry]:
    """Entries of every leaf of ``variables`` under ``sub`` (params and
    batch_stats), named as the port's modules name them; ``lead`` leading
    (member) axes."""
    table: List[_Entry] = []
    for coll in ("params", "batch_stats"):
        tree = variables.get(coll) or {}
        for p in sub:
            tree = tree.get(p, {})
        for path, a in _leaves(tree):
            owner, leaf, layout = list(path[:-1]), path[-1], None
            if coll == "batch_stats":
                leaf = _STATS[leaf]
            elif owner[-1:] in (["Dense_0"], ["Conv_0"]) and leaf in ("kernel", "bias"):
                if leaf == "kernel":
                    layout = "T" if owner[-1] == "Dense_0" else "conv"
                    leaf = "weight"
                owner = owner[:-1]
            elif leaf == "kernel" and np.ndim(a) - lead == 4:  # a plain flax conv
                leaf, layout = "weight", "conv"
            elif leaf == "scale":
                leaf = "weight"
            table.append((port + _port_name(owner + [leaf]), (coll,) + sub + tuple(path), layout))
    return table


def _walk_from_port(state_dict, lead: int = 0, prefix: str = "", sub: Tuple[str, ...] = ()) -> List[_Entry]:
    """The inverse of :func:`_walk_from_flax`, from the port's names and
    shapes: a 1-D ``weight`` is a norm's scale, a 2-D one a ``TorchLinear``
    (``Dense_0``), a 4-D one a conv (``Conv_0`` inside a ``TorchConv_*``)."""
    table: List[_Entry] = []
    for key, t in state_dict.items():
        if not key.startswith(prefix):
            continue
        segs = key[len(prefix):].split(".")
        owner, leaf = [], segs[-1]
        rest = segs[:-1]
        while rest:
            if rest[0] == "blocks" and len(rest) > 1 and rest[1].isdigit():
                owner.append(f"block{rest[1]}")
                rest = rest[2:]
            else:
                owner.append(rest.pop(0))
        if leaf in ("running_mean", "running_var"):
            table.append((key, ("batch_stats",) + sub + tuple(owner) + (leaf[len("running_"):],), None))
            continue
        weight = state_dict.get(key[:-len(leaf)] + "weight") if leaf in ("weight", "bias") else None
        nd = None if weight is None else weight.dim() - lead
        inner = ()
        if nd == 2:
            inner = ("Dense_0",)
        elif nd == 4 and owner and owner[-1].startswith("TorchConv_"):
            inner = ("Conv_0",)
        name, layout = leaf, None
        if leaf == "weight":
            name, layout = ("scale", None) if nd == 1 else ("kernel", "T" if nd == 2 else "conv")
        table.append((key, ("params",) + sub + tuple(owner) + inner + (name,), layout))
    return table


def module_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax variables ``{"params"[, "batch_stats"]}`` of an encoder or a
    backbone (``models/encoders.py``, ``models/backbones.py``, the ViT) ->
    the port module's state dict."""
    return _from_flax(variables, _walk_from_flax(variables))


def module_to_flax(state_dict) -> Dict[str, Any]:
    """The port module's state dict -> flax variables ``{"params"[,
    "batch_stats"]}``."""
    return _flax_tree(state_dict, _walk_from_port(state_dict))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(a) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor of its dtype; bfloat16, which
    numpy holds as ml_dtypes', goes through float32 (exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.astype(np.float32), order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def _from_flax(tree, table) -> Dict[str, torch.Tensor]:
    return {key: _tensor(_to_port(np.asarray(_get(tree, path)), layout)) for key, path, layout in table}


def _flax_tree(state_dict, table) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, path, layout in table:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = state_dict[key].detach().float().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(_to_flax(a, layout))
    return out


def guidance_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax SEViTGuidance variables ``{"params": ...}`` -> the port's
    ``SEViTGuidance`` state_dict."""
    return _from_flax(variables, _guidance_table(variables["params"]))


def vit_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``ViT`` variables ``{"params": ...}`` -> the port's ``ViT``
    state_dict (:func:`module_from_flax`)."""
    return module_from_flax(variables)


def mlp_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``MappingMLP`` variables ``{"params": ...}`` (a stage-1b
    checkpoint's tree) -> the port's ``MappingMLP`` state_dict."""
    return _from_flax(variables, _mlp_table(len(variables["params"])))


def _guidance_port_table(state_dict) -> List[_Entry]:
    table = _walk_from_port(state_dict, 0, "vit.", ("vit",))
    heads = sorted({int(k.split(".")[1]) for k in state_dict if k.startswith("mlps.")})
    for i in heads:
        n_layers = sum(k.startswith(f"mlps.{i}.") and k.endswith(".weight") for k in state_dict)
        table += _mlp_table(n_layers, f"mlps.{i}.", ("params", f"mlp{i}"))
    return table


def guidance_to_flax(state_dict) -> Dict[str, Any]:
    """The port's ``SEViTGuidance`` state_dict -> flax variables."""
    return _flax_tree(state_dict, _guidance_port_table(state_dict))


def _flax_members_table(variables) -> List[_Entry]:
    conv = "encoder_x" in variables["params"]
    return _members_table(_walk_from_flax(variables, 1, "encoder_x.", ("encoder_x",)) if conv else ())


def members_from_flax(stacked_vars) -> Dict[str, torch.Tensor]:
    """Member-stacked flax ConditionalModel variables ``{"params",
    "batch_stats"}`` (leading axis M) of any arch, with or without
    guidance -> the port's stacked ``ConditionalModel`` state_dict."""
    return _from_flax(stacked_vars, _flax_members_table(stacked_vars))


def _members_port_table(state_dict) -> List[_Entry]:
    conv = any(k.startswith("encoder_x.") for k in state_dict)
    return _members_table(_walk_from_port(state_dict, 1, "encoder_x.", ("encoder_x",)) if conv else ())


def members_to_flax(state_dict) -> Dict[str, Any]:
    """The port's stacked ``ConditionalModel`` state_dict -> member-stacked
    flax variables."""
    return _flax_tree(state_dict, _members_port_table(state_dict))


def flax_leaf_order(state_dict, kind: str) -> List[str]:
    """The keys of an ``SEViTGuidance`` (``kind="guidance"``) or stacked
    ``ConditionalModel`` (``kind="members"``) state_dict in the order of
    their flax leaves, as ``jax.tree.map`` visits a variable tree (keys
    sorted at every level)."""
    table = _guidance_port_table(state_dict) if kind == "guidance" else _members_port_table(state_dict)
    return [key for key, _, _ in sorted(table, key=lambda e: e[1])]


# ---------------------------------------------------------------- train states


def _optax_parts(opt_state):
    """The optax states (named tuples) of a chain, nested tuples walked."""
    if hasattr(opt_state, "_fields"):
        yield opt_state
    elif isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            yield from _optax_parts(part)


def _opt_from_optax(opt_state, table, step) -> Dict[str, Any]:
    """An optax chain's state (clip, L2, Adam / bf16 Adam / AdamW, RMSProp,
    SGD, schedules) -> the port's ``Optimizer`` state: the count (the
    chain's own, else ``step``) and each moment by name."""
    out: Dict[str, Any] = {}
    for part in _optax_parts(opt_state):
        for slot in ("mu", "nu", "trace"):
            if slot in part._fields:
                out[slot] = _from_flax({"params": getattr(part, slot)}, table)
        if "count" in part._fields and "count" not in out:
            out["count"] = _tensor(part.count).to(torch.int32)
    out.setdefault("count", _tensor(step).to(torch.int32))
    return out


def _param_entries(table: List[_Entry]) -> List[_Entry]:
    return [e for e in table if e[1][0] == "params"]


def member_state_from_jax(state):
    """A member-stacked JAX ``MemberTrainState`` (params, batch_stats, the
    optax state, EMA, step; leading axis M) -> the port's
    ``train.MemberTrainState``, the same numbers in the port's layout."""
    from ladine_tpu_torch.train.diffusion_trainer import MemberTrainState

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    table = _flax_members_table(variables)
    params = _param_entries(table)
    tensors = _from_flax(variables, table)
    stats = {k: v for k, v in tensors.items() if k.endswith(("running_mean", "running_var"))}
    return MemberTrainState(
        params={k: v for k, v in tensors.items() if k not in stats},
        batch_stats=stats,
        opt_state=_opt_from_optax(state.opt_state, params, state.step),
        ema=_from_flax({"params": state.ema}, params),
        step=_tensor(state.step).to(torch.int32),
    )


def train_state_from_jax(state, kind: str):
    """A JAX ``TrainState`` of the stage-1 fine-tune (``kind="vit"``: the
    ViT or any backbone, with the ``batch_stats`` of a BatchNorm one) or of
    the stacked mapping MLPs (``kind="mapping"``) -> the port's
    ``train.TrainState``; the parameters by the port module's state-dict
    names."""
    from ladine_tpu_torch.train.classifier_trainer import TrainState

    stats = getattr(state, "batch_stats", None)
    if kind == "vit":
        table = _walk_from_flax({"params": state.params, "batch_stats": stats or {}})
    elif kind == "mapping":
        table = _mlp_table(len(state.params))
    else:
        raise ValueError(f"kind must be 'vit' or 'mapping', got {kind!r}")
    params = _param_entries(table)
    tensors = _from_flax({"params": state.params, "batch_stats": stats}, table)
    return TrainState(
        params={k: tensors[k] for k, _, _ in params},
        opt_state=_opt_from_optax(state.opt_state, params, state.step),
        step=_tensor(state.step).to(torch.int32),
        batch_stats={k: v for k, v in tensors.items() if k.endswith(("running_mean", "running_var"))} or None,
    )
