"""The ('member', 'data') mesh over ``torch.distributed``, and what a rank holds.

Counterpart of ``ladine_tpu/parallel/mesh.py``. The JAX package is one
program over a 2-D device mesh, and GSPMD inserts its collectives from
sharding annotations. Here every rank runs its own process and holds:

* its rows of the stacked member axis (parameters, optimizer state, EMA,
  MC samples): :func:`member_slice`, :func:`shard_members`;
* its rows of the image batch: :func:`data_slice`, :func:`shard_data`;
* the guidance whole (the JAX package replicates it).

The collectives are explicit: :func:`gather_members` / :func:`gather_data`
bring a sharded axis back whole on every rank, :func:`reduce_data` and
:func:`reduce_scatter_data` sum gradients over the data axis, and inside
:func:`global_batch` the BatchNorms take their statistics over the global
batch (:func:`batch_moments`, a differentiable all-reduce), as ``jnp.mean``
over a sharded axis lowers to a psum in the JAX package.

The JAX helpers that place a whole copy on every device (``replicated``,
``shard_pytree``, ``tree_shardings``) have no counterpart: a rank's copy
of an unsharded tensor is the tensor. ``fsdp_shardings`` becomes
:func:`fsdp_plan`, the names of the leaves whose second axis shards over
'data'; :func:`shard_tree` / :func:`gather_tree` apply such a plan to a
tree of member-stacked tensors.

``gloo`` takes CUDA tensors in every collective used here
(``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``;
checked on the H100 machine's torch 2.11), staging them through host memory
itself: a caller that initializes ``gloo`` for tensors on a card chooses
that (two ranks that share one card, which ``nccl`` refuses). The code
here runs the same collectives on every backend.

Tensor, pipeline and sequence parallelism are absent, as in the JAX
package: the largest layer is 150528 x 4096 and the longest sequence 197
tokens.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch.distributed.device_mesh import DeviceMesh

MEMBER_AXIS = "member"
DATA_AXIS = "data"


def factor_mesh(n_devices: int, num_members: int) -> Tuple[int, int]:
    """Pick (member_dim, data_dim) with member_dim * data_dim == n_devices.

    member_dim is the largest divisor of n_devices that also divides
    num_members (so the member axis shards evenly); the rest goes to data.
    With the reference's 5 members on 8 devices this is (1, 8), pure data
    parallelism, while 10 members on 8 devices gives (2, 4)."""
    best = 1
    for d in range(1, n_devices + 1):
        if n_devices % d == 0 and num_members % d == 0:
            best = d
    return best, n_devices // best


def make_mesh(n_devices: Optional[int] = None, num_members: int = 5, device_type: str = "cuda") -> DeviceMesh:
    """The ('member', 'data') mesh over ranks 0..n_devices-1 of the default
    process group (all of its ranks when None), of the shape
    :func:`factor_mesh` picks. The caller has initialized the process group
    and so chosen its backend. Every rank of the group calls this; a rank
    past ``n_devices`` is left out of the mesh (:func:`in_mesh`)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    m, d = factor_mesh(n, num_members)
    return mesh_of(torch.arange(n).reshape(m, d), device_type)


def mesh_of(ranks, device_type: str = "cuda") -> DeviceMesh:
    """A ('member', 'data') mesh over an explicit 2-D array of ranks."""
    return DeviceMesh(device_type, torch.as_tensor(np.asarray(ranks)), mesh_dim_names=(MEMBER_AXIS, DATA_AXIS))


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    """(member_dim, data_dim)."""
    return tuple(int(s) for s in mesh.mesh.shape)


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def _axis(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(this rank's index along ``axis``, the axis' size)."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def _slice(mesh: DeviceMesh, axis: str, n: int) -> slice:
    i, k = _axis(mesh, axis)
    if n % k:
        raise ValueError(f"{n} rows do not tile the {axis} axis of size {k}")
    return slice(i * (n // k), (i + 1) * (n // k))


def member_slice(mesh: DeviceMesh, num_members: int) -> slice:
    """This rank's rows of a member axis of ``num_members``."""
    return _slice(mesh, MEMBER_AXIS, num_members)


def data_slice(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch``."""
    return _slice(mesh, DATA_AXIS, batch)


def tiles_data(mesh: DeviceMesh, batch: int) -> bool:
    """Whether a batch of ``batch`` rows shards over 'data' (else it runs
    unsharded there, as the JAX package's tail batches do)."""
    return batch % _axis(mesh, DATA_AXIS)[1] == 0


def request_rows(mesh: DeviceMesh, members: int, batch: int) -> Tuple[slice, slice, bool]:
    """This rank's (member rows, batch rows) of a request of ``batch``
    images, and whether its batch is sharded: a batch that does not tile
    'data' runs whole on every rank of a member row."""
    sharded = tiles_data(mesh, batch)
    return member_slice(mesh, members), data_slice(mesh, batch) if sharded else slice(None), sharded


def _take(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    s = _slice(mesh, axis, x.shape[dim])
    return x.narrow(dim, s.start, s.stop - s.start).clone(memory_format=torch.contiguous_format)


def shard_members(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of ``x``'s leading member axis (a copy: the whole
    tensor can be freed)."""
    return _take(x, mesh, MEMBER_AXIS, 0)


def shard_data(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``x``'s batch axis ``dim`` (a copy)."""
    return _take(x, mesh, DATA_AXIS, dim)


def _leading(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` (contiguous) as (the product of its axes before ``dim``, ``n``
    rows, the rest): each leading index a contiguous block whose rows are
    axis ``dim``, so a collective on axis ``dim`` is one call a block with
    no transposed copy (an FSDP leaf's blocks are its members)."""
    return x.view((int(np.prod(x.shape[:dim])), n) + tuple(x.shape[dim + 1:]))


def _gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    k = _axis(mesh, axis)[1]
    if k == 1:
        return x
    x = x.contiguous()
    out = x.new_empty(x.shape[:dim] + (k * x.shape[dim],) + x.shape[dim + 1:])
    xs, outs = _leading(x, dim, x.shape[dim]), _leading(out, dim, out.shape[dim])
    for i in range(xs.shape[0]):
        dist.all_gather_into_tensor(outs[i], xs[i], group=mesh.get_group(axis))
    return out


def gather_members(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole leading member axis on every rank, from each rank's rows."""
    return _gather(x, mesh, MEMBER_AXIS, 0)


def gather_data(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """The whole data-sharded axis ``dim`` on every rank."""
    return _gather(x, mesh, DATA_AXIS, dim)


def reduce_data(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of ``x`` over the data axis, in place, on every rank."""
    if _axis(mesh, DATA_AXIS)[1] > 1:
        dist.all_reduce(x, group=mesh.get_group(DATA_AXIS))
    return x


def reduce_scatter_data(x: torch.Tensor, mesh: DeviceMesh, dim: int = 1) -> torch.Tensor:
    """The sum of ``x`` over the data axis, this rank's rows of axis ``dim``."""
    k = _axis(mesh, DATA_AXIS)[1]
    if k == 1:
        return x
    x = x.contiguous()
    out = x.new_empty(x.shape[:dim] + (x.shape[dim] // k,) + x.shape[dim + 1:])
    xs, outs = _leading(x, dim, x.shape[dim]), _leading(out, dim, out.shape[dim])
    for i in range(xs.shape[0]):
        dist.reduce_scatter_tensor(outs[i], xs[i], group=mesh.get_group(DATA_AXIS))
    return out


def gather_samples(samples: torch.Tensor, mesh: DeviceMesh, batch_sharded: bool) -> torch.Tensor:
    """The whole (M, K, B, C) MC samples on every rank from each rank's
    (m, K, b, C): its member rows, and its batch rows where the batch was
    sharded (the batch axis first for the gather: the samples are small)."""
    if batch_sharded:
        samples = gather_data(samples.permute(2, 0, 1, 3).contiguous(), mesh).permute(1, 2, 0, 3)
    return gather_members(samples.contiguous(), mesh)


def sharded_samples(mesh: DeviceMesh, noise: torch.Tensor, run) -> torch.Tensor:
    """The whole (M, K, B, C) MC samples of a request on every rank, from
    its whole draws ``noise`` (n, M, K, B, C): ``run(rows, cols, z)``
    samples this rank's member rows ``rows`` on its batch rows ``cols``
    (every row where the batch does not tile 'data') with ``z``, its slice
    of the draws; the results are gathered."""
    rows, cols, sharded = request_rows(mesh, noise.shape[1], noise.shape[3])
    return gather_samples(run(rows, cols, noise[:, rows, :, cols].contiguous()), mesh, sharded)


def is_writer() -> bool:
    """Whether this process writes files and logs: rank 0 of an initialized
    process group, or a process without one. Two ranks writing one file
    corrupt it without an error."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Every rank of ``mesh`` waits for every other: an all-reduce over
    'data', then over 'member' (each rank waits for its row, then for every
    row), on a tensor of the mesh's device type."""
    flag = torch.zeros(1, device=_barrier_device(mesh))
    for axis in (DATA_AXIS, MEMBER_AXIS):
        if _axis(mesh, axis)[1] > 1:
            dist.all_reduce(flag, group=mesh.get_group(axis))
    if flag.is_cuda:
        torch.cuda.synchronize(flag.device)


def _barrier_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ------------------------------------------------------------ BatchNorm statistics

_BATCH_MESH: contextvars.ContextVar = contextvars.ContextVar("ladine_batch_mesh", default=None)


@contextlib.contextmanager
def global_batch(mesh: Optional[DeviceMesh]):
    """Within this block train-mode BatchNorms take their statistics over
    the global batch, the batch rows of every rank of ``mesh``'s data axis
    (None: the local batch, as without a mesh)."""
    token = _BATCH_MESH.set(mesh)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def batch_moments(x: torch.Tensor, dims, keepdim: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) over ``dims``; inside :func:`global_batch` over the
    global batch: the local sums go through one differentiable all-reduce
    over 'data' (its backward sums the other ranks' gradients), then divide
    by the global count."""
    mesh = _BATCH_MESH.get()
    if mesh is None or _axis(mesh, DATA_AXIS)[1] == 1:
        return x.mean(dim=dims, keepdim=keepdim), (x * x).mean(dim=dims, keepdim=keepdim)
    dims = [dims] if isinstance(dims, int) else list(dims)
    count = int(np.prod([x.shape[d] for d in dims])) * _axis(mesh, DATA_AXIS)[1]
    sums = torch.stack([x.sum(dim=dims, keepdim=keepdim), (x * x).sum(dim=dims, keepdim=keepdim)])
    sums = dist_fn.all_reduce(sums, group=mesh.get_group(DATA_AXIS))
    return sums[0] / count, sums[1] / count


# ------------------------------------------------------------------- FSDP


def fsdp_plan(tree: Any, mesh: DeviceMesh, min_size: int = 2**18) -> frozenset:
    """The FSDP layout of member-stacked train state: the names of the
    leaves that also shard their second axis over 'data' (every leaf's
    leading axis shards over 'member'). The JAX package's leaf rule: at
    least 2 dims, at least ``min_size`` elements and a second dim that tiles
    the data axis. ``tree``: a dict of tensors by name, or a train state,
    whose ``params`` and ``batch_stats`` name its leaves (its optimizer
    moments and EMA carry the parameters' names and shapes)."""
    d = mesh_shape(mesh)[1]
    if dataclasses.is_dataclass(tree):
        tree = {**tree.params, **tree.batch_stats}
    return frozenset(k for k, v in tree.items()
                     if v.dim() >= 2 and v.numel() >= min_size and v.shape[1] % d == 0)


def _map_tree(tree: Any, fn, name: Optional[str] = None) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree, name)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tree(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return tree


def shard_tree(tree: Any, mesh: DeviceMesh, fsdp: Iterable[str] = ()) -> Any:
    """This rank's part of a tree of member-stacked tensors (nested dicts,
    lists and dataclasses such as ``MemberTrainState``): the member rows of
    every tensor, and the data columns (axis 1) of a tensor whose dict key
    is in ``fsdp``."""
    fsdp = frozenset(fsdp)

    def one(x, name):
        x = shard_members(x, mesh)
        return shard_data(x, mesh, dim=1) if name in fsdp else x

    return _map_tree(tree, one)


def gather_tree(tree: Any, mesh: DeviceMesh, fsdp: Iterable[str] = ()) -> Any:
    """The whole tree on every rank from each rank's part (:func:`shard_tree`'s inverse)."""
    fsdp = frozenset(fsdp)

    def one(x, name):
        x = gather_data(x, mesh, dim=1) if name in fsdp else x
        return gather_members(x, mesh)

    return _map_tree(tree, one)


@dataclasses.dataclass(frozen=True)
class Window:
    """Where a rank's (m, c) view of a member-stacked leaf sits in the
    whole (M, N) view: rows ``row0``.. of ``rows``, columns ``col0``.. of
    ``cols``. An FSDP leaf's data shard of axis 1 is a run of whole columns."""

    rows: int
    row0: int
    cols: int
    col0: int


def leaf_window(view: torch.Tensor, mesh: Optional[DeviceMesh] = None, data_sharded: bool = False) -> Window:
    """The :class:`Window` of this rank's (m, c) ``view`` on ``mesh`` (the
    whole view without one)."""
    m, c = view.shape
    if mesh is None:
        return Window(m, 0, c, 0)
    i, mk = _axis(mesh, MEMBER_AXIS)
    j, dk = _axis(mesh, DATA_AXIS) if data_sharded else (0, 1)
    return Window(m * mk, m * i, c * dk, c * j)
