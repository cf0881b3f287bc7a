"""Stage-1 -> stage-3 guidance checkpoint assembly.

Counterpart of ``ladine_tpu/utils/assemble.py``, on the port's state dicts.
Stage 1a saves ``{"params": <ViT state dict>}`` (``cli/train_transformer``),
stage 1b one ``{"params": <MappingMLP state dict>}`` per member under
``MLPs/block_{k}`` (``cli/train_mapping``), and stage 3 reads one
``SEViTGuidance`` tree ``{"params": <its state dict>}`` (``vit.*``,
``mlps.{k}.*``). These helpers convert between the two layouts both ways:

    assemble_guidance(vit_ckpt, mlp_dir)      stage-1 ckpts -> guidance tree
    split_guidance(gvars, num_members)        guidance tree -> stage-1 parts
    export_guidance_stage1(gvars, out, ds)    guidance tree -> stage-1 ckpts
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ladine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

Tensors = Dict[str, torch.Tensor]


def _infer_num_members(mlp_dir: str) -> int:
    ks = []
    for name in os.listdir(mlp_dir):
        if name.startswith("block_") and name[len("block_"):].isdigit():
            ks.append(int(name[len("block_"):]))
    if not ks:
        raise FileNotFoundError(f"no block_<k> checkpoints under {mlp_dir}")
    n = max(ks) + 1
    missing = sorted(set(range(n)) - set(ks))
    if missing:
        raise FileNotFoundError(f"missing MLP checkpoints {missing} under {mlp_dir}")
    return n


def assemble_guidance(
    vit_ckpt: str,
    mlp_dir: Optional[str] = None,
    mlp_ckpts: Optional[Sequence[str]] = None,
    num_members: Optional[int] = None,
) -> Dict[str, Tensors]:
    """``{"params": <SEViTGuidance state dict>}`` (on the CPU) from the
    stage-1a checkpoint and the stage-1b ones: ``mlp_dir`` holding
    ``block_0 .. block_{K-1}``, or ``mlp_ckpts`` in member order (exactly
    one of the two). ``num_members`` is checked when given."""
    if (mlp_dir is None) == (mlp_ckpts is None):
        raise ValueError("pass exactly one of mlp_dir / mlp_ckpts")
    if mlp_dir is not None:
        n = _infer_num_members(mlp_dir)
        mlp_ckpts = [os.path.join(mlp_dir, f"block_{k}") for k in range(n)]
    if num_members is not None and len(mlp_ckpts) != num_members:
        raise ValueError(f"expected {num_members} mapping-MLP checkpoints, found {len(mlp_ckpts)}")
    vit_tree, _ = load_checkpoint(vit_ckpt)
    if "params" not in vit_tree:
        raise ValueError(f"{vit_ckpt} is not a stage-1a ViT checkpoint (no 'params')")
    params = {f"vit.{k}": v for k, v in vit_tree["params"].items()}
    for k, path in enumerate(mlp_ckpts):
        tree, meta = load_checkpoint(path)
        if "params" not in tree:
            raise ValueError(f"{path} is not a stage-1b MLP checkpoint (no 'params')")
        saved_member = meta.get("member")
        if saved_member is not None and int(saved_member) != k:
            raise ValueError(f"{path} is MLP member {saved_member}, expected {k}: pass checkpoints in member order")
        params.update({f"mlps.{k}.{name}": v for name, v in tree["params"].items()})
    return {"params": params}


def validate_guidance_tree(gvars: Dict[str, Tensors], template: Tensors, cast: bool = True,
                           what: str = "assembled guidance") -> Dict[str, Tensors]:
    """Check ``gvars["params"]`` against ``template`` (a state dict, of a
    module on the ``meta`` device, say: only names, shapes and dtypes are
    read): the same names and shapes, else a ValueError naming the first
    offenders. Returns the tree with each tensor cast to the template's
    dtype (``cast``), or as it is."""
    params = gvars["params"]
    t_keys, g_keys = set(template), set(params)
    if t_keys != g_keys:
        raise ValueError(
            f"{what} does not match the model: missing={sorted(t_keys - g_keys)[:5]} "
            f"extra={sorted(g_keys - t_keys)[:5]} (checkpoint trained at different "
            "dimensions than this config?)")
    for k in sorted(t_keys):
        if tuple(template[k].shape) != tuple(params[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(params[k].shape)} vs model "
                             f"{tuple(template[k].shape)}")
    if not cast:
        return gvars
    return {**gvars, "params": {k: v.to(template[k].dtype) for k, v in params.items()}}


def split_guidance(gvars: Dict[str, Tensors], num_members: Optional[int] = None
                   ) -> Tuple[Dict[str, Tensors], List[Dict[str, Tensors]]]:
    """Inverse of :func:`assemble_guidance`: a guidance tree -> (the ViT's
    stage-1a tree, [each MLP's stage-1b tree])."""
    params = gvars["params"]
    if num_members is None:
        num_members = len({k.split(".")[1] for k in params if k.startswith("mlps.")})
    vit = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
    mlps = []
    for i in range(num_members):
        prefix = f"mlps.{i}."
        mlps.append({"params": {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}})
    return {"params": vit}, mlps


def export_guidance_stage1(gvars: Dict[str, Tensors], out_dir: str, dataset: str,
                           num_members: Optional[int] = None) -> List[str]:
    """A guidance tree written back in the stage-1 layout
    (``{out}/vit_{DS}`` + ``{out}/{DS}/MLPs/block_{k}``), the inverse that
    turns a ``--pretrain_guidance`` or ``--joint_train`` run's guidance into
    stage-1 checkpoints. Returns the written paths."""
    vit_tree, mlp_trees = split_guidance(gvars, num_members)
    vit_path = os.path.join(out_dir, f"vit_{dataset}")
    save_checkpoint(vit_path, vit_tree, {"kind": "vit", "dataset": dataset})
    paths = [vit_path]
    for k, tree in enumerate(mlp_trees):
        p = os.path.join(out_dir, dataset, "MLPs", f"block_{k}")
        save_checkpoint(p, tree, {"kind": "mapping_mlp", "member": k})
        paths.append(p)
    return paths
