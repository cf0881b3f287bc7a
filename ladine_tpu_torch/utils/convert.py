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

Train states (``member_state_from_jax``, ``train_state_from_jax``) carry
over with their optimizer state (optax's ``mu``/``nu``/``trace`` and
count), EMA and step, so both frameworks can continue one run.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# (port key, flax path, layout change); the change is None (copy),
# "T" (swap the last two axes) or "conv" (flax conv -> torch conv)
_Entry = Tuple[str, Tuple[str, ...], Optional[str]]


def _dense(port: str, path: Tuple[str, ...], layout: Optional[str] = "T") -> List[_Entry]:
    return [(f"{port}.weight", path + ("kernel",), layout), (f"{port}.bias", path + ("bias",), None)]


def _norm(port: str, path: Tuple[str, ...]) -> List[_Entry]:
    return [(f"{port}.weight", path + ("scale",), None), (f"{port}.bias", path + ("bias",), None)]


def _vit_table(vit: Dict[str, Any], port: str = "vit.", path: Tuple[str, ...] = ("params", "vit")) -> List[_Entry]:
    depth = sum(k.startswith("block") for k in vit)
    table = [
        (f"{port}patch_proj.weight", path + ("patch_proj", "kernel"), "conv"),
        (f"{port}patch_proj.bias", path + ("patch_proj", "bias"), None),
        (f"{port}cls_token", path + ("cls_token",), None),
        (f"{port}pos_embed", path + ("pos_embed",), None),
    ]
    for i in range(depth):
        p, b = path + (f"block{i}",), f"{port}blocks.{i}"
        table += _norm(f"{b}.norm1", p + ("norm1",)) + _norm(f"{b}.norm2", p + ("norm2",))
        for name, sub in (("attn.qkv", ("attn", "qkv")), ("attn.proj", ("attn", "proj")),
                          ("mlp.fc1", ("mlp", "fc1")), ("mlp.fc2", ("mlp", "fc2"))):
            table += _dense(f"{b}.{name}", p + sub + ("Dense_0",))
    table += _norm(f"{port}norm", path + ("norm",))
    table += _dense(f"{port}head", path + ("head", "Dense_0"))
    return table


def _mlp_table(n_layers: int, port: str = "", path: Tuple[str, ...] = ("params",)) -> List[_Entry]:
    table: List[_Entry] = []
    for j in range(n_layers):
        table += _dense(f"{port}layers.{j}", path + (f"linear{j + 1}", "Dense_0"))
    return table


def _guidance_table(params: Dict[str, Any]) -> List[_Entry]:
    table = _vit_table(params["vit"])
    for i in range(sum(k.startswith("mlp") for k in params)):
        table += _mlp_table(len(params[f"mlp{i}"]), f"mlps.{i}.", ("params", f"mlp{i}"))
    return table


def _members_table() -> List[_Entry]:
    table: List[_Entry] = []
    for name in ("enc_lin1", "enc_lin2", "enc_lin3", "lin4"):
        table += _dense(name, ("params", name, "Dense_0"), layout=None)
    for name in ("enc_bn1", "enc_bn2", "norm", "unetnorm1", "unetnorm2", "unetnorm3"):
        table += _norm(name, ("params", name))
        table += [(f"{name}.running_mean", ("batch_stats", name, "mean"), None),
                  (f"{name}.running_var", ("batch_stats", name, "var"), None)]
    for name in ("lin1", "lin2", "lin3"):
        table += _dense(f"{name}.linear", ("params", name, "TorchLinear_0", "Dense_0"), layout=None)
        table.append((f"{name}.embed", ("params", name, "embed"), None))
    return table


def _to_port(a: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return np.swapaxes(a, -1, -2)
    if layout == "conv":
        return np.transpose(a, (3, 2, 0, 1))
    return a


def _to_flax(a: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return np.swapaxes(a, -1, -2)
    if layout == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    return a


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
    state_dict."""
    return _from_flax(variables, _vit_table(variables["params"], "", ("params",)))


def mlp_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``MappingMLP`` variables ``{"params": ...}`` (a stage-1b
    checkpoint's tree) -> the port's ``MappingMLP`` state_dict."""
    return _from_flax(variables, _mlp_table(len(variables["params"])))


def guidance_to_flax(state_dict, depth: int, n_mlps: int, n_layers: int = 4) -> Dict[str, Any]:
    """The port's ``SEViTGuidance`` state_dict -> flax variables."""
    skeleton = {"vit": {f"block{i}": None for i in range(depth)}}
    skeleton.update({f"mlp{i}": [None] * n_layers for i in range(n_mlps)})
    return _flax_tree(state_dict, _guidance_table(skeleton))


def members_from_flax(stacked_vars) -> Dict[str, torch.Tensor]:
    """Member-stacked flax ConditionalModel variables ``{"params",
    "batch_stats"}`` (leading axis M) -> the port's stacked
    ``ConditionalModel`` state_dict."""
    return _from_flax(stacked_vars, _members_table())


def members_to_flax(state_dict) -> Dict[str, Any]:
    """The port's stacked ``ConditionalModel`` state_dict -> member-stacked
    flax variables."""
    return _flax_tree(state_dict, _members_table())


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

    table = _members_table()
    params = _param_entries(table)
    tensors = _from_flax({"params": state.params, "batch_stats": state.batch_stats}, table)
    stats = {k: v for k, v in tensors.items() if k.endswith(("running_mean", "running_var"))}
    return MemberTrainState(
        params={k: v for k, v in tensors.items() if k not in stats},
        batch_stats=stats,
        opt_state=_opt_from_optax(state.opt_state, params, state.step),
        ema=_from_flax({"params": state.ema}, params),
        step=_tensor(state.step).to(torch.int32),
    )


def train_state_from_jax(state, kind: str):
    """A JAX ``TrainState`` of the ViT fine-tune (``kind="vit"``) or of the
    stacked mapping MLPs (``kind="mapping"``) -> the port's
    ``train.TrainState``; the parameters by the port's ``ViT`` or
    ``MappingMLP`` state-dict names."""
    from ladine_tpu_torch.train.classifier_trainer import TrainState

    if kind == "vit":
        table = _vit_table(state.params, "", ("params",))
    elif kind == "mapping":
        table = _mlp_table(len(state.params))
    else:
        raise ValueError(f"kind must be 'vit' or 'mapping', got {kind!r}")
    return TrainState(
        params=_from_flax({"params": state.params}, table),
        opt_state=_opt_from_optax(state.opt_state, table, state.step),
        step=_tensor(state.step).to(torch.int32),
    )
