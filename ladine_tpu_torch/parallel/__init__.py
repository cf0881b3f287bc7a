"""The ('member', 'data') mesh of the port, on ``torch.distributed``.

Counterpart of ``ladine_tpu/parallel/``. The JAX package is one SPMD
program over a 2-D ``('member', 'data')`` device mesh whose collectives
GSPMD derives from sharding annotations. The port runs one process per
card: a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("member", "data")``, built over the default process
group by ``make_mesh(n_devices=None, num_members=5, device_type="cuda")``
in the shape ``factor_mesh`` picks (the JAX rule), or across nodes by
``make_multislice_mesh``. Each rank holds its rows of the member axis
(stacked states, weights, MC samples) and its rows of the batch; the
guidance, small, is whole on every rank. The collectives are explicit
(``parallel/mesh.py``): gradients are summed over 'data', BatchNorm
statistics are taken over the global batch, outputs are gathered whole on
every rank, and random draws are drawn whole from a generator that every
rank seeds alike and sliced, so a sharded run computes what one process
computes. The caller initializes the process group and so chooses the
backend: ``torchrun`` with ``nccl``, one card a rank, is the multi-card
deployment; ``gloo`` serves the CPU, and two ranks that share one card.
The library never picks a backend and never moves a tensor off the device
it was given. The JAX helpers that place a whole copy on every device
(``replicated``, ``shard_pytree``, ``tree_shardings``) have no counterpart,
and ``fsdp_shardings`` is ``fsdp_plan``.
"""

from ladine_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MEMBER_AXIS,
    data_slice,
    factor_mesh,
    fsdp_plan,
    gather_data,
    gather_members,
    gather_tree,
    make_mesh,
    member_slice,
    shard_data,
    shard_members,
    shard_tree,
)
from ladine_tpu_torch.parallel.multislice import (
    describe_mesh,
    group_devices_by_slice,
    make_multislice_mesh,
    multislice_factor,
)

__all__ = [
    "DATA_AXIS",
    "MEMBER_AXIS",
    "data_slice",
    "describe_mesh",
    "factor_mesh",
    "fsdp_plan",
    "gather_data",
    "gather_members",
    "gather_tree",
    "group_devices_by_slice",
    "make_mesh",
    "make_multislice_mesh",
    "member_slice",
    "multislice_factor",
    "shard_data",
    "shard_members",
    "shard_tree",
]
