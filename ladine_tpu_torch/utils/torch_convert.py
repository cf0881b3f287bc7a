"""The reference's PyTorch artifacts, read into and written from the port.

Counterpart of ``ladine_tpu/utils/torch_convert.py``. The reference's three
training stages hand off ``.pth`` files: the fine-tuned timm 0.3.x ViT-B/16
and the mapping ``Classifier`` heads as whole-module pickles, and each
diffusion member as ``{'noise_estimator': state_dict, 'optimizer': ...,
'epoch': ...}``. The JAX package maps them onto flax trees; here they map
straight onto the port's modules:

    sd = guidance_from_reference(load_torch_state_dict(vit_pth),
                                 [load_torch_state_dict(p) for p in mlp_pths])
    guidance.load_state_dict(sd)
    model.load_state_dict(members_from_reference(
        [load_torch_state_dict(p) for p in member_pths]))

The port's ViT and mapping heads keep torch layouts, so their tensors copy
over under new names. The stacked members keep the flax Dense layout
``(M, in, out)`` with a leading member axis, so a reference ``nn.Linear``
weight ``(out, in)`` is transposed and the members are stacked. The
exporters (``export_*``) are the exact inverses, one member or head at a
time, and write float32, the reference's storage dtype (bf16 -> float32 ->
bf16 is exact).
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# (port name, reference name) of the member layers
_MEMBER_LINEARS = (("enc_lin1", "encoder_x.0"), ("enc_lin2", "encoder_x.3"),
                   ("enc_lin3", "encoder_x.6"), ("lin1.linear", "lin1.lin"),
                   ("lin2.linear", "lin2.lin"), ("lin3.linear", "lin3.lin"), ("lin4", "lin4"))
_MEMBER_NORMS = (("enc_bn1", "encoder_x.1"), ("enc_bn2", "encoder_x.4"), ("norm", "norm"),
                 ("unetnorm1", "unetnorm1"), ("unetnorm2", "unetnorm2"), ("unetnorm3", "unetnorm3"))
_BN_STATS = ("weight", "bias", "running_mean", "running_var")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(v))


def _state(obj) -> Mapping[str, torch.Tensor]:
    """A module's state_dict, or the mapping itself."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def load_torch_state_dict(path: str, key: Optional[str] = None) -> StateDict:
    """One ``.pth`` file as a flat state dict of CPU tensors.

    Takes the reference's three formats: a plain state dict; a whole-module
    pickle, reduced by ``.state_dict()``; and the diffusion checkpoint
    wrapper ``{'noise_estimator': state_dict, ...}``, unwrapped on its own
    unless ``key`` names the entry to take. A plain state dict is read with
    ``weights_only=True``. A whole-module pickle runs the pickled class's
    code, so it is read only from a file that holds one, and its class
    (timm's ViT, the reference's ``Classifier``) must be importable: where it
    is not, the error names the missing module, and the remedy is to load the
    file where it imports and save its ``state_dict()``."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # not tensors and containers: a pickled module
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except (ImportError, AttributeError) as e:
            missing = getattr(e, "name", None) or str(e)
            raise ModuleNotFoundError(
                f"{path} is a whole-module pickle whose class cannot be imported here "
                f"(missing: {missing}); load it where that module imports and save its "
                f"state_dict()") from e
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if key is not None:
        obj = obj[key]
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
    elif isinstance(obj, dict) and "noise_estimator" in obj:
        obj = obj["noise_estimator"]
    return {k: _tensor(v) for k, v in obj.items()}


def save_torch_state_dict(sd: Mapping[str, object], path: str, wrapper_key: Optional[str] = None,
                          epoch: int = 0) -> None:
    """Write a state dict (tensors or numpy arrays) as a ``.pth`` the
    reference loads: floating tensors as float32 on the CPU.
    ``wrapper_key='noise_estimator'`` writes the diffusion checkpoint
    wrapper ``{'noise_estimator': sd, 'optimizer': {}, 'epoch': epoch}``."""

    def cpu(v):
        t = _tensor(v).cpu()
        return t.float() if t.is_floating_point() else t

    tensors = {k: cpu(v).contiguous() for k, v in sd.items()}
    obj = {wrapper_key: tensors, "optimizer": {}, "epoch": epoch} if wrapper_key else tensors
    torch.save(obj, path)


# ------------------------------------------------------- reference -> port


def vit_from_reference(sd: Mapping[str, object]) -> StateDict:
    """timm 0.3.x ``vit_base_patch16_224`` state dict -> the port's ``ViT``
    state dict (the depth is the number of blocks in ``sd``)."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    out = {"patch_proj.weight": sd["patch_embed.proj.weight"],
           "patch_proj.bias": sd["patch_embed.proj.bias"]}
    for k, v in sd.items():
        if k.startswith(("blocks.", "norm.", "head.")) or k in ("cls_token", "pos_embed"):
            out[k] = v
    return out


def mapping_mlp_from_reference(sd: Mapping[str, object]) -> StateDict:
    """The reference ``Classifier`` (``linear1`` .. ``linear4``) -> the
    port's ``MappingMLP`` state dict."""
    return {f"layers.{i}.{p}": _tensor(sd[f"linear{i + 1}.{p}"])
            for i in range(4) for p in ("weight", "bias")}


def member_from_reference(sd: Mapping[str, object]) -> StateDict:
    """One reference ``ConditionalModel`` (arch ``linear``, guidance on) ->
    one member of the port's stacked ``ConditionalModel``, without the
    member axis: dense weights ``(in, out)``, gates ``(n_steps, N)``."""
    sd = {k: _tensor(v) for k, v in sd.items()}
    out: StateDict = {}
    for ours, theirs in _MEMBER_LINEARS:
        out[f"{ours}.weight"] = sd[f"{theirs}.weight"].transpose(0, 1)
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]
    for ours, theirs in _MEMBER_NORMS:
        for p in _BN_STATS:
            out[f"{ours}.{p}"] = sd[f"{theirs}.{p}"]
    for i in (1, 2, 3):
        out[f"lin{i}.embed"] = sd[f"lin{i}.embed.weight"]
    return out


def members_from_reference(sds: Sequence[Mapping[str, object]]) -> StateDict:
    """Reference ``ConditionalModel`` state dicts, one a member -> the
    port's stacked ``ConditionalModel`` state dict (member i at index i)."""
    members = [member_from_reference(sd) for sd in sds]
    return {k: torch.stack([m[k] for m in members]) for k in members[0]}


def guidance_from_reference(vit_sd: Mapping[str, object],
                            mlp_sds: Sequence[Mapping[str, object]]) -> StateDict:
    """The timm ViT and the mapping heads' state dicts (head i = MLP i) ->
    the port's ``SEViTGuidance`` state dict."""
    out = {f"vit.{k}": v for k, v in vit_from_reference(vit_sd).items()}
    for i, sd in enumerate(mlp_sds):
        out.update({f"mlps.{i}.{k}": v for k, v in mapping_mlp_from_reference(sd).items()})
    return out


# ------------------------------------------------------- port -> reference


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _prefixed(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def export_vit(vit) -> StateDict:
    """The port's ``ViT`` (or the ``SEViTGuidance`` holding it; a module or
    its state dict) -> a timm 0.3.x ``vit_base_patch16_224`` state dict.

    The reference's stage-1 artifact is a whole-module pickle: load this
    into ``timm.create_model('vit_base_patch16_224')`` with a
    ``nn.Linear(768, C)`` head and ``torch.save`` the module."""
    sd = _state(vit)
    if any(k.startswith("vit.") for k in sd):
        sd = _prefixed(sd, "vit.")
    out = {"patch_embed.proj.weight": _f32(sd["patch_proj.weight"]),
           "patch_embed.proj.bias": _f32(sd["patch_proj.bias"])}
    for k, v in sd.items():
        if not k.startswith("patch_proj."):
            out[k] = _f32(v)
    return out


def export_mapping_mlp(guidance, index: Optional[int] = None) -> StateDict:
    """Mapping head ``index`` of the port's ``SEViTGuidance`` (or, with
    ``index=None``, a ``MappingMLP``; a module or its state dict) -> the
    reference ``Classifier`` state dict."""
    sd = _state(guidance)
    if index is not None:
        sd = _prefixed(sd, f"mlps.{index}.")
    n_layers = sum(k.endswith(".weight") for k in sd)
    if n_layers == 0:
        raise KeyError(f"no mapping head {index} in the given state")
    return {f"linear{i + 1}.{p}": _f32(sd[f"layers.{i}.{p}"])
            for i in range(n_layers) for p in ("weight", "bias")}


def export_conditional_model(model, member: int) -> StateDict:
    """Member ``member`` of the port's stacked ``ConditionalModel`` (a
    module or its state dict) -> a reference ``ConditionalModel`` state
    dict, the payload of its ``{'noise_estimator': ...}`` checkpoint, with
    the ``num_batches_tracked`` buffers torch's BatchNorm1d keeps (0)."""
    sd = _state(model)
    out: StateDict = {}
    for ours, theirs in _MEMBER_LINEARS:
        out[f"{theirs}.weight"] = _f32(sd[f"{ours}.weight"][member].transpose(0, 1))
        out[f"{theirs}.bias"] = _f32(sd[f"{ours}.bias"][member])
    for ours, theirs in _MEMBER_NORMS:
        for p in _BN_STATS:
            out[f"{theirs}.{p}"] = _f32(sd[f"{ours}.{p}"][member])
        out[f"{theirs}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    for i in (1, 2, 3):
        out[f"lin{i}.embed.weight"] = _f32(sd[f"lin{i}.embed"][member])
    return out

