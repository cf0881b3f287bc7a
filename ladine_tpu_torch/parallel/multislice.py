"""Multi-node mesh recipe: ensemble members across nodes.

Counterpart of ``ladine_tpu/parallel/multislice.py``. A TPU "slice" is a
node here: NVLink inside a node stands where ICI did, and the network
between nodes where DCN did. The members never exchange a byte during
training, so the member axis goes across nodes and the data axis within
one, and the per-step collectives decompose as

* gradient all-reduce over 'data'  -> inside a node, on NVLink;
* 'member' axis                    -> no per-step collectives: the
  network carries only the per-member losses and the checkpoint gathers.

:func:`make_multislice_mesh` builds that layout; the inverse (data across
nodes) would all-reduce a ~650 M-parameter gradient over the network every
step and is not offered. A rank's node is ``rank // LOCAL_WORLD_SIZE``
(``torchrun`` numbers the ranks of a node contiguously); with
``num_slices`` given, or without ``LOCAL_WORLD_SIZE``, the ranks split into
``num_slices`` equal contiguous groups, as the JAX package splits a device
list that carries no slice index. The result is an ordinary
('member', 'data') ``DeviceMesh``, so every path of the port takes it.
The log strings are the JAX package's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ladine_tpu_torch.parallel.mesh import mesh_of, mesh_shape


def group_devices_by_slice(ranks: Sequence[int], num_slices: Optional[int] = None,
                           local_world_size: Optional[int] = None) -> List[List[int]]:
    """Group ranks by node: ``rank // local_world_size`` (default: the
    ``LOCAL_WORLD_SIZE`` that ``torchrun`` sets) when ``num_slices`` is not
    given, else ``num_slices`` equal contiguous groups. Raises if the
    grouping is ragged: a mesh needs equal rows."""
    ranks = [int(r) for r in ranks]
    if local_world_size is None and os.environ.get("LOCAL_WORLD_SIZE"):
        local_world_size = int(os.environ["LOCAL_WORLD_SIZE"])
    if num_slices is None and local_world_size:
        groups: dict = {}
        for r in ranks:
            groups.setdefault(r // local_world_size, []).append(r)
        out = [groups[k] for k in sorted(groups)]
    else:
        n = num_slices or 1
        if len(ranks) % n:
            raise ValueError(f"{len(ranks)} devices do not split into {n} equal slices")
        per = len(ranks) // n
        out = [ranks[i * per:(i + 1) * per] for i in range(n)]
    sizes = {len(g) for g in out}
    if len(sizes) != 1:
        raise ValueError(f"ragged slices: sizes {sorted(len(g) for g in out)}")
    return out


def multislice_factor(num_slices: int, num_members: int) -> Tuple[int, int]:
    """(member_dim, slices_per_member_group): member_dim is the largest
    divisor of ``num_members`` that divides ``num_slices``, so each row of
    the member axis owns whole nodes. 5 members on 5 nodes: (5, 1); on 10
    nodes: (5, 2), each member data-parallel over two nodes (its gradient
    all-reduce then crosses the network, as :func:`describe_mesh` says)."""
    best = 1
    for d in range(1, num_members + 1):
        if num_members % d == 0 and num_slices % d == 0:
            best = d
    return best, num_slices // best


def make_multislice_mesh(num_members: int = 5, num_slices: Optional[int] = None,
                         ranks: Optional[Sequence[int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """('member', 'data') mesh whose member axis strides across nodes: row
    ``i`` holds the ranks of the node(s) of member group ``i``, the data
    axis the ranks within them. ``ranks`` default to every rank of the
    default process group."""
    ranks = list(ranks) if ranks is not None else list(range(dist.get_world_size()))
    groups = group_devices_by_slice(ranks, num_slices)
    member_dim, per_group = multislice_factor(len(groups), num_members)
    rows = [[r for g in groups[i * per_group:(i + 1) * per_group] for r in g] for i in range(member_dim)]
    return mesh_of(rows, device_type)


def describe_mesh(mesh: DeviceMesh, num_slices: int) -> str:
    """One line on which axis crosses nodes, for a launch log."""
    m, d = mesh_shape(mesh)
    slice_size = (m * d) // num_slices
    data_crosses_dcn = d > slice_size
    return (
        f"multislice mesh member={m} data={d} over {num_slices} slices: "
        + (
            "data axis spans slices — per-step gradient psum rides DCN "
            "(acceptable only if step time >> DCN latency)"
            if data_crosses_dcn
            else "data axis within a slice (ICI); member axis across slices "
            "(no per-step collectives)"
        )
    )
