"""One CUDA graph per batch shape: the port's counterpart of the JAX
package's compiled program per batch shape (``jax.jit``'s cache).

``GraphCache(program, device)`` runs ``program(*inputs)``, a function of
device tensors that returns a tuple of tensors and neither copies from the
host nor waits on the device (``infer/program.py``, or a loaded
``torch.export`` program). The first call at a set of input shapes warms
the program up once, eagerly, on a side stream (the kernels' builds and
``ctypes`` loads, their ``cudaFuncSetAttribute`` calls, cuBLAS's
workspaces), then captures it into a ``torch.cuda.CUDAGraph`` whose static
buffers hold the inputs. Every call copies its inputs into those buffers,
replays the graph and copies the outputs to the host. The graphs of one
cache share one memory pool. A failed capture raises: nothing falls back to
an eager run.

The static buffers are shared, so a lock serialises copy-in, replay and
copy-out: concurrent callers (the HTTP server's threads, a
``MicroBatcher``'s worker) each get their own outputs.

``kernels._build.launch_counts`` counts the wrappers' calls, and a replay
makes none. So a capture's counts are taken off the counter again (a
capture launches nothing) and added at every replay; the eager warm-up
launches and counts as any eager run does.
"""

from __future__ import annotations

import collections
import gc
import threading
import time
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ladine_tpu_torch.kernels import _build

# held by a capture while the garbage collector is off (see GraphCache._capture)
_GC_OFF = threading.Lock()


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    launches: collections.Counter  # each kernel's launches in one replay


class GraphCache:
    """The CUDA graphs of ``program`` on ``device``, one per input shapes."""

    def __init__(self, program: Callable[..., Tuple[torch.Tensor, ...]], device):
        self._program = program
        self._device = torch.device(device)
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._lock = threading.Lock()
        self.capture_seconds: Dict[tuple, float] = {}  # warm-up + capture, by input shapes

    def __call__(self, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The program's outputs on ``inputs`` (host or device tensors), as
        host tensors."""
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        with self._lock:
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = self._capture(key, inputs)
            for buf, t in zip(g.inputs, inputs):
                buf.copy_(t)
            g.graph.replay()
            _build.launch_counts.update(g.launches)
            return tuple(o.cpu() for o in g.outputs)

    def launches(self, *inputs: torch.Tensor) -> collections.Counter:
        """Each kernel's launches in one replay at these inputs' shapes."""
        return self._graphs[tuple((tuple(t.shape), t.dtype) for t in inputs)].launches

    def _capture(self, key, inputs) -> _Graph:
        t0 = time.perf_counter()
        static = tuple(torch.empty(t.shape, dtype=t.dtype, device=self._device) for t in inputs)
        for buf, t in zip(static, inputs):
            buf.copy_(t)
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._program(*static)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = collections.Counter(_build.launch_counts)
        # no garbage collection inside the capture: collecting an unreachable
        # CUDA graph there (a dropped predictor's) frees its memory, which a
        # capture forbids, and voids this capture. The collector is the
        # process's, so captures take one process-wide lock around it.
        with _GC_OFF:
            enabled = gc.isenabled()
            gc.collect()
            gc.disable()
            try:
                # thread_local: another thread's work on its own stream (a caller's
                # noise draw, a copy to the host) does not void this capture
                with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                    outputs = tuple(self._program(*static))
            finally:
                if enabled:
                    gc.enable()
        launches = collections.Counter(_build.launch_counts) - before
        for name, n in launches.items():
            _build.launch_counts[name] -= n
        self.capture_seconds[key] = time.perf_counter() - t0
        return _Graph(graph, static, outputs, launches)
