"""Checkpoints: a directory holding a tensor tree and a metadata sidecar.

Counterpart of ``ladine_tpu/utils/checkpoint.py``, with the same layout: a
directory per checkpoint holding the tree and ``ladine_meta.json``. The JAX
package writes the tree with orbax; here it is one ``torch.save`` file
(``tree.pt``), read back with ``torch.load(weights_only=True)``, so loading
a checkpoint runs no pickled code. The tree is nested dicts (and lists) of
tensors and plain values. The port cannot read the JAX package's orbax
directories, nor the JAX package this one's.

Train states (``train/``: a ``MemberTrainState`` of stacked diffusion
members, or a ``TrainState`` of the ViT or the mapping MLPs) are saved as
``{"states": {field: ...}, "guidance": ...}`` by :func:`save_train_state`,
float32 or with ``lowmem``'s bfloat16 moments and EMA as they are, the
member states marked ``meta["ema_init"] = "zero"`` (the debiased
accumulator ``train/ema.py::ema_params_from_ckpt`` reads). A light
checkpoint keeps only what evaluation reads (params, EMA, batch statistics
and the update counts), its float tensors in a compute dtype.

A state sharded over a mesh (``parallel/``) is gathered whole and written
by rank 0 alone, in the one-process format, while the other ranks wait;
every rank reads a checkpoint and keeps its part. So a checkpoint written
on a mesh loads in one process, and the other way round.
"""

from __future__ import annotations

import json
import os
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ladine_tpu_torch.parallel.mesh import gather_tree, is_writer, mesh_barrier, shard_tree

TREE_FILE = "tree.pt"
META_FILE = "ladine_meta.json"


def save_checkpoint(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (and ``metadata``, if given) into the directory
    ``path``, replacing what a checkpoint there held. Tensors are written from
    whatever device they are on; each file appears whole or not at all."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, TREE_FILE)
    torch.save(tree, target + ".tmp")
    os.replace(target + ".tmp", target)
    if metadata is not None:
        meta = os.path.join(path, META_FILE)
        with open(meta + ".tmp", "w") as f:
            json.dump(metadata, f)
        os.replace(meta + ".tmp", meta)


def load_checkpoint(path: str, map_location: Any = "cpu") -> Tuple[Any, Dict]:
    """(tree, metadata); the tensors land on ``map_location``."""
    path = os.path.abspath(path)
    tree_path = os.path.join(path, TREE_FILE)
    if not os.path.exists(tree_path):
        raise FileNotFoundError(f"no checkpoint at {path} ({TREE_FILE} missing)")
    tree = torch.load(tree_path, map_location=map_location, weights_only=True)
    return tree, load_checkpoint_meta(path)


def load_checkpoint_meta(path: str) -> Dict:
    """Just the metadata sidecar ({} when there is none): cheap, for callers
    that need the geometry before they load the tree."""
    meta_path = os.path.join(os.path.abspath(path), META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def best_checkpoint_name(kind: str, member: int, epoch: int, accuracy: float) -> str:
    """The reference's naming scheme: ``diffu{k}_ckpt_best_eph{E}_acc{A}``."""
    return f"{kind}{member}_ckpt_best_eph{epoch}_acc{accuracy:.4f}"


_LIGHT_FIELDS = ("params", "ema", "batch_stats", "step")


def _cast(tensors: Dict[str, torch.Tensor], dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    if dtype is None:
        return tensors
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}


def save_train_state(path: str, state: Any, metadata: Optional[Dict] = None, guidance: Any = None,
                     light: bool = False, light_dtype: Optional[torch.dtype] = None,
                     mesh=None, fsdp=()) -> Dict:
    """Write a train state (its fields by name) and ``guidance`` (a state
    dict, or None) into the checkpoint directory ``path``. Member states
    get ``meta["ema_init"] = "zero"`` and ``meta["lowmem"]`` (bfloat16
    EMA), then ``metadata`` wins. ``light`` (member states): params, EMA,
    batch statistics and steps only, float tensors cast to ``light_dtype``
    (None: as they are). On a ``mesh`` (``state`` this rank's part,
    ``fsdp`` its data-sharded leaves) every rank calls this: the state is
    gathered, rank 0 writes, and the others wait for it. Returns the
    metadata written."""
    if mesh is not None:
        state = gather_tree(state, mesh, fsdp)
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    meta: Dict[str, Any] = {"light": bool(light)}
    if "ema" in fields:
        meta["ema_init"] = "zero"
        meta["lowmem"] = next(iter(fields["ema"].values())).dtype == torch.bfloat16
    meta.update(metadata or {})
    if light:
        if "ema" not in fields:
            raise ValueError("a light checkpoint is of diffusion-member states (they carry an EMA)")
        fields = {k: fields[k] for k in _LIGHT_FIELDS}
        fields["params"] = _cast(fields["params"], light_dtype)
        fields["ema"] = _cast(fields["ema"], light_dtype)
    if is_writer():
        save_checkpoint(path, {"states": fields, "guidance": guidance}, meta)
    if mesh is not None:
        mesh_barrier(mesh)
    return meta


def load_train_state(path: str, device: Any = "cpu", mesh=None, fsdp=()) -> Tuple[Any, Any, Dict]:
    """(states, guidance, metadata) of a :func:`save_train_state`
    checkpoint, tensors on ``device``: a ``MemberTrainState`` or
    ``TrainState``, or for a light checkpoint the dict of its fields. On a
    ``mesh``: the member states' part of this rank (``fsdp`` as in
    :func:`save_train_state`); the guidance stays whole."""
    from ladine_tpu_torch.train import MemberTrainState, TrainState

    tree, meta = load_checkpoint(path, map_location=device)
    if "states" not in tree:
        raise ValueError(f"{path} is not a train-state checkpoint (kind={meta.get('kind')!r})")
    st = tree["states"]
    if meta.get("light"):
        states = st
    elif "ema" in st:
        states = MemberTrainState(**st)
    else:
        states = TrainState(**st)
    if mesh is not None:
        states = shard_tree(states, mesh, fsdp)
    return states, tree.get("guidance"), meta
