"""Build the port's CUDA sources and load them with ctypes.

Each ``ladine_tpu_torch/csrc/<name>.cu`` (with the ``*.cuh`` headers it
includes) is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas=-v

into ``ladine_tpu_torch/_build/<name>-<source hash>.so`` (listed in
``.gitignore``) and loaded with ``ctypes``. The sources expose a plain C
interface: every pointer and the stream are ``void*``, and each launch
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
No PyTorch header is compiled, so a build takes seconds.

Each wrapper adds one to ``launch_counts[<kernel>]`` where it launches its
kernel, so a run can show that its main path went through the kernels.

Each wrapper calls a ``torch.library`` custom op of the namespace
:data:`NAMESPACE` (``torch.ops.ladine_tpu_torch.<op>``): its CPU
implementation is the kernel's plain version, its CUDA implementation the
checked launch, and its fake implementation gives the output shapes and
dtypes, so that ``torch.export`` and CUDA graph capture can carry the
kernels. Registering an op builds nothing: the library is built at the
first launch.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # each kernel's registers and spills, in the build log
)

NAMESPACE = "ladine_tpu_torch"
launch_counts: collections.Counter = collections.Counter()
# runs of a plain backward registered for a kernel's op (K3's VJP): no
# kernel launches there, so these are counted apart from the launches
vjp_runs: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> str:
    """The library's path: the hash covers the source and every shared
    header (``csrc/*.cuh``), so a changed header rebuilds its includers."""
    digest = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for part in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, part), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for nvcc; its log, kept beside the library so that a source
    built earlier still reports its registers and spills."""
    if started is None:
        log_path = _target(name)[:-3] + ".log"
        if not os.path.exists(log_path):
            return ""
        with open(log_path) as f:
            return f.read()
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, one nvcc each, all started together;
    returns each one's nvcc log."""
    names = list(names)
    with _lock:
        started = [(n, _start(n)) for n in names]
        return {n: _finish(n, s) for n, s in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib


def check(err: int, name: str, kernel: str) -> None:
    """Raise if the launch of ``kernel`` from ``csrc/<name>.cu`` failed."""
    if err != 0:
        describe = load(name).cuda_error_string
        describe.argtypes, describe.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{kernel}: CUDA launch failed: {describe(err).decode()} (cudaError {err})"
        )
