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


def _guidance_table(params: Dict[str, Any]) -> List[_Entry]:
    vit = params["vit"]
    depth = sum(k.startswith("block") for k in vit)
    n_mlps = sum(k.startswith("mlp") for k in params)
    table = [
        ("vit.patch_proj.weight", ("params", "vit", "patch_proj", "kernel"), "conv"),
        ("vit.patch_proj.bias", ("params", "vit", "patch_proj", "bias"), None),
        ("vit.cls_token", ("params", "vit", "cls_token"), None),
        ("vit.pos_embed", ("params", "vit", "pos_embed"), None),
    ]
    for i in range(depth):
        p, b = ("params", "vit", f"block{i}"), f"vit.blocks.{i}"
        table += _norm(f"{b}.norm1", p + ("norm1",)) + _norm(f"{b}.norm2", p + ("norm2",))
        for port, name in (("attn.qkv", ("attn", "qkv")), ("attn.proj", ("attn", "proj")),
                           ("mlp.fc1", ("mlp", "fc1")), ("mlp.fc2", ("mlp", "fc2"))):
            table += _dense(f"{b}.{port}", p + name + ("Dense_0",))
    table += _norm("vit.norm", ("params", "vit", "norm"))
    table += _dense("vit.head", ("params", "vit", "head", "Dense_0"))
    for i in range(n_mlps):
        n_layers = len(params[f"mlp{i}"])
        for j in range(n_layers):
            table += _dense(f"mlps.{i}.layers.{j}", ("params", f"mlp{i}", f"linear{j + 1}", "Dense_0"))
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


def _from_flax(tree, table) -> Dict[str, torch.Tensor]:
    return {
        key: torch.from_numpy(np.array(_to_port(np.asarray(_get(tree, path)), layout), order="C"))
        for key, path, layout in table
    }


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
