"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. It loads, warms
up every batch shape the cell's traffic uses, measures for ``--seconds``,
judges a sample of the window's outputs against the plain reference, and
prints as its last line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared, with its limit (also the last lines
of standard error). Without a CUDA card, with fewer cards than the cell
asks for, with a ``--trace 1`` run whose trace recorded nothing, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.

The kernels build into the port's own build directory inside the checkout
(``ladine_tpu_torch/_build/``), so only a checkout's first run compiles.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

_T0 = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "ladine_tpu")


def process_start() -> float:
    """The process's start on time.perf_counter's clock (from /proc where
    it can be read; this module's import otherwise)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 3600 else _T0
    except (OSError, ValueError, IndexError):
        return _T0


def jax_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def finite(x: float) -> float:
    return x if math.isfinite(x) else 1e308


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_start()

    import torch

    from portbench import harness

    spec_path = harness.ROOT / "BENCHMARK.json"
    if not spec_path.exists():
        print(f"portbench: no BENCHMARK.json at {harness.ROOT}", file=sys.stderr)
        return 2
    spec = harness.load_json(spec_path)
    cell, _, _ = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2

    from ladine_tpu_torch.device import card_line, resolve_device

    device = resolve_device("cuda")
    from portbench.trace import NoTrace

    try:
        result, checks = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                                          device=device, process_start=started,
                                          log=lambda m: print(m, file=sys.stderr))
    except NoTrace as e:
        print(f"portbench: traced run without a trace: {e}", file=sys.stderr)
        return 4
    loaded = jax_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded in this process: {loaded}", file=sys.stderr)
        return 3
    result["device"]["card"] = card_line(device)
    result["checks"] = {k: dict(value=finite(v["value"]), limit=v["limit"]) for k, v in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
