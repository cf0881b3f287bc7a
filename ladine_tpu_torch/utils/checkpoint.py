"""Checkpoints: a directory holding a tensor tree and a metadata sidecar.

Counterpart of ``ladine_tpu/utils/checkpoint.py``, with the same layout: a
directory per checkpoint holding the tree and ``ladine_meta.json``. The JAX
package writes the tree with orbax; here it is one ``torch.save`` file
(``tree.pt``), read back with ``torch.load(weights_only=True)``, so loading
a checkpoint runs no pickled code. The tree is nested dicts (and lists) of
tensors and plain values. The port cannot read the JAX package's orbax
directories, nor the JAX package this one's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

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
