"""One run of one cell: set up, warm up, measure, judge, report.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

    portbench/configs/<config>.json      sizes, preset, dtype, control, limits
    portbench/families/<family>.py       weights, the program, draws, reference
    portbench/traffic/<traffic>.json     a closed or an open loop's parameters
    portbench/metrics/<metric>.py        read(run) -> a number, or None
    portbench/work/<part>.py             operations, bytes and kernel names

A closed loop sends the next call when the last one has returned: each
call takes ``batch`` images from a pool made from the seed in set-up, and
fresh draws. An open loop sends requests of ``sizes`` images at the times
of a Poisson schedule of ``rate_images_per_s`` through a ``MicroBatcher``;
every seed gets the same requests, sizes and gaps in the same cyclic order,
entered at a point of its own. ``phases`` in the traffic file, where it is
given, modulates the rate: on/off bursts or any other cycle of rates, as
data. A request is timed from when it was due.

A traced run records the device over the end of the window
(``trace.traced_span``), not all of it, to keep its reading short.

Once the window has closed, the peak memory read and the program freed, a
sample of the finished requests drawn from the seed is run again through
the family's plain reference on weights made again from the seed, and the
judge (``judge.py``) holds the program's outputs to it.
"""

from __future__ import annotations

import concurrent.futures
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import judge
from portbench.trace import DeviceTrace, busy_seconds, by_name, clip, gaps, label_gaps

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GRACE_S = 60.0  # how long past the window a request may still come back
WARM = 5  # the draws' stream of the warm-up calls


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``portbench/<kind>/<name>.py``, loaded by its path."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str, base: Path = HERE):
    """(cell, config, traffic) of the workload ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(base.parent / conf["file"])
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def metrics_of(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    if not trace:
        return [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    reports = {m["name"] for m in metrics_of(spec, cell_name, False)}
    return [m for m in spec["per_layer"]
            if cell_name in m.get("workloads", [cell_name]) and m["moves"] in reports]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of a non-empty list."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


class Run:
    """What a per-layer metric's reader may read of one run."""

    def __init__(self, cell, cfg, traffic, base: Path = HERE):
        self.cell, self.config, self.traffic, self.base = cell, cfg, traffic, base
        self.window_s = 0.0
        self.requests: List[dict] = []  # every request due in the window
        self.calls: Optional[List[dict]] = None  # the batcher's device calls (open loops)
        self.batcher_stats: Optional[dict] = None
        self.capture_seconds: Optional[float] = None
        self.launches: Dict[str, int] = {}  # kernel launches in the traced span (kernels._build.launch_counts)
        self.tick = lambda elapsed: None  # called between requests with the window's elapsed seconds
        self.device_events = None  # trace.Interval list of the traced span (traced runs)
        self.trace_window_s: Optional[float] = None
        self.trace_stall_s = 0.0  # what starting the trace took from the window (traced runs)
        self.spans: List[tuple] = []  # the harness's host spans (name, start, end)

    def work(self, name: str) -> ModuleType:
        return load_module("work", name, self.base)

    @property
    def completed(self) -> List[dict]:
        return [r for r in self.requests if r.get("out") is not None]


# ------------------------------------------------------------------ loops


def closed_loop(run: Run, predict, family, cfg, traffic, pool, seed, seconds, device):
    b, size = traffic["batch"], len(pool)
    start = time.perf_counter()
    j = 0
    while (elapsed := time.perf_counter() - start) < seconds:
        run.tick(elapsed)
        row0 = (j * b) % size
        images = pool[row0:row0 + b]
        t0 = time.perf_counter()
        z = family.noise(cfg, b, seed, j, device)
        t1 = time.perf_counter()
        rec = dict(index=j, ids=list(range(row0, row0 + b)), due=t0, out=None)
        try:
            rec["out"] = family.outputs(predict(images, noise=z))
        except Exception as e:  # a failed request counts as failed, the loop goes on
            rec["error"] = repr(e)
        rec["done"] = time.perf_counter()
        run.spans += [("noise draw", t0, t1), ("predict", t1, rec["done"])]
        run.requests.append(rec)
        j += 1
    return start, run.requests[-1]["done"]


def phase_segments(phases, seconds: float):
    """([(host start, rate start, multiplier)] of each phase that sends,
    rate seconds in all) over ``seconds``: ``phases`` is [[seconds,
    multiplier], ...], cycled, and a second of a phase is ``multiplier``
    seconds at the traffic's rate (0: off, no request)."""
    segments, t, u = [], 0.0, 0.0
    while t < seconds:
        for length, mult in phases:
            step = min(float(length), seconds - t)
            if mult > 0 and step > 0:
                segments.append((t, u, float(mult)))
            t, u = t + step, u + step * float(mult)
            if t >= seconds:
                break
    return segments, u


def open_schedule(traffic, seconds: float, seed: int):
    """(due offset, size) of every request. Every seed gets the same
    requests in the same cyclic order, which ``pattern_seed`` fixes, entered
    at a point of its own: the same count, sizes and gaps, so the same
    bursts for the tail to see. The gaps are the exponential distribution's
    quantiles at the mid-points of n equal slices, laid on the clock of
    ``phases`` where the traffic gives them."""
    sizes, shares = traffic["sizes"], traffic["shares"]
    mean_size = sum(s * p for s, p in zip(sizes, shares))
    rate = traffic["rate_images_per_s"] / mean_size
    segments, rate_s = phase_segments(traffic.get("phases", [[seconds, 1.0]]), seconds)
    n = max(1, round(rate * rate_s))
    counts = [round(n * p) for p in shares]
    counts[-1] = n - sum(counts[:-1])
    pattern = np.random.default_rng(traffic.get("pattern_seed", 0))
    order = pattern.permutation(np.repeat(sizes, counts))
    gaps_s = pattern.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    start = int(np.random.default_rng([int(seed), 7]).integers(n))
    order, gaps_s = np.roll(order, -start), np.roll(gaps_s, -start)
    due = np.cumsum(gaps_s) - gaps_s[0]
    if "phases" in traffic:  # from the rate's clock to the host's
        t0, u0, mult = (np.array(c) for c in zip(*segments))
        k = np.searchsorted(u0, due, side="right") - 1
        due = t0[k] + (due - u0[k]) / mult[k]
    return [(float(d), int(s)) for d, s in zip(due, order)]


def open_loop(run: Run, predict, family, cfg, traffic, pool, seed, seconds, device):
    from ladine_tpu_torch.infer.batching import MicroBatcher

    index = {bytes(pool[i, 0, :8, 0].tobytes()): i for i in range(len(pool))}
    calls: List[dict] = []
    run.calls = calls

    def predict_fn(images):
        c = len(calls)
        ids = [index[bytes(images[r, 0, :8, 0].tobytes())] for r in range(len(images))]
        real = len(dict.fromkeys(ids))  # the batcher pads with copies of the last row
        z = family.noise(cfg, len(images), seed, c, device)
        t0 = time.perf_counter()
        out = predict(images, noise=z)
        t1 = time.perf_counter()
        calls.append(dict(index=c, ids=ids, rows=len(images), pad=len(images) - real, t0=t0, t1=t1))
        run.spans.append(("predict", t0, t1))
        return out

    batcher = MicroBatcher(predict_fn, max_batch=traffic["max_batch"], max_wait_ms=traffic["max_wait_ms"])
    schedule = open_schedule(traffic, seconds, seed)
    cursor = 0
    for due, size in schedule:
        run.requests.append(dict(ids=[(cursor + i) % len(pool) for i in range(size)], out=None, offset=due))
        cursor += size
    pool_ex = concurrent.futures.ThreadPoolExecutor(max_workers=traffic["threads"])
    list(pool_ex.map(lambda _: None, range(traffic["threads"])))  # start the threads in set-up

    def client(rec):
        try:
            rec["out"] = family.outputs(batcher.predict(pool[rec["ids"]]))
        except Exception as e:
            rec["error"] = repr(e)
        rec["done"] = time.perf_counter()

    start = time.perf_counter()
    futures = []
    for rec in run.requests:
        rec["due"] = start + rec["offset"]
        run.tick(time.perf_counter() - start)
        wait = rec["due"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec["sent"] = time.perf_counter()
        futures.append(pool_ex.submit(client, rec))
    run.spans.append(("batcher wait", start, time.perf_counter()))
    concurrent.futures.wait(futures, timeout=max(0.0, start + seconds + GRACE_S - time.perf_counter()))
    end = max((r["done"] for r in run.requests if "done" in r), default=start + seconds)
    run.batcher_stats = batcher.stats()
    batcher.close()
    pool_ex.shutdown(wait=False, cancel_futures=True)
    for rec in run.requests:
        rec.setdefault("done", start + seconds + GRACE_S)  # never came back: missing
    return start, end


LOOPS = {"closed": closed_loop, "open": open_loop}


def warm_batches(traffic) -> List[int]:
    """Every batch shape this traffic's calls can take."""
    if traffic["kind"] == "closed":
        return [traffic["batch"]]
    from ladine_tpu_torch.infer.batching import MicroBatcher

    return MicroBatcher.bucket_sizes(traffic["max_batch"])


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ a run


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
             process_start: Optional[float] = None, log=print, base: Path = HERE):
    """One run. Returns the result (the last line's object but ``checks``)
    and the judge's checks."""
    from ladine_tpu_torch.kernels import _build

    t_begin = time.perf_counter() if process_start is None else process_start
    cell, cfg, traffic = find_cell(spec, cell_name, base)
    family = load_module("families", cfg["family"], base)
    run = Run(cell, cfg, traffic, base)
    on_card = torch.device(device).type == "cuda"

    weights = family.make_weights(cfg, seed, device)
    pred = family.build(cfg, weights, device)
    del weights
    pool = family.image_pool(cfg, traffic["pool"], seed, device)
    for b in warm_batches(traffic):  # the first call at a shape captures its graph, the second replays it
        for k in range(2):
            pred.predict(pool[:b], noise=family.noise(cfg, b, seed, k, device, stream=WARM))
    if on_card:
        torch.cuda.synchronize()
    graphs = getattr(pred, "_graphs", None)
    run.capture_seconds = sum(graphs.capture_seconds.values()) if graphs is not None else None

    tracer = DeviceTrace(seconds) if trace and on_card else None
    before = {}  # launch counts where the traced span starts
    if tracer is not None:
        def tick(elapsed):
            if tracer.poll(elapsed):
                before.update(_build.launch_counts)
        run.tick = tick
    start, end = LOOPS[traffic["kind"]](run, pred.predict, family, cfg, traffic, pool, seed, seconds, device)
    setup_s = start - t_begin
    if on_card:
        torch.cuda.synchronize()
    if tracer is not None:
        run.launches = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items() if v != before.get(k, 0)}
        tracer.close()
        tracer.require()
        run.trace_stall_s = tracer.stall_s
    run.window_s = end - start if traffic["kind"] == "closed" else seconds
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    calls_ms = sorted((e - s) * 1e3 for name, s, e in run.spans if name == "predict")
    if calls_ms:
        log(f"portbench: {len(calls_ms)} predict calls, ms min {calls_ms[0]:.2f} p50 "
            f"{percentile(calls_ms, 50):.2f} p95 {percentile(calls_ms, 95):.2f} max {calls_ms[-1]:.2f}; "
            f"outside them {run.window_s - sum(calls_ms) / 1e3:.3f} s of the window")

    failed = sum(r.get("out") is None for r in run.requests)
    breakdown = None
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name() if on_card else "cpu",
                       count=1, memory_peak_bytes=int(peak))
    if tracer is not None:
        t0, t1 = tracer.t0, start + run.window_s
        run.device_events = clip(tracer.events, t0, t1)
        run.trace_window_s = t1 - t0
        device_info["busy_s"] = busy_seconds(run.device_events)
        device_info["window_s"] = run.trace_window_s
        breakdown = dict(device_ops=by_name(run.device_events),
                         idle_gaps=label_gaps(gaps(run.device_events, t0, t1), run.spans, start))
        log(f"portbench: traced {len(tracer.events)} device activities over {t1 - t0:.3f} s; starting the "
            f"profiler took {tracer.stall_s:.3f} s of the window, reading it back {tracer.read_s:.3f} s after it")

    metrics = {}
    if not trace:
        for m in metrics_of(spec, cell_name, False):
            if m["name"] == "setup_s":
                metrics["setup_s"] = dict(value=setup_s, unit=m["unit"])
            else:
                value = end_to_end(m["name"], run)
                if value is not None:
                    metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        for m in metrics_of(spec, cell_name, True):
            value = load_module("metrics", m["name"], base).read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])

    # the program's part is over: free it, then judge a sample against the reference
    picked = judge.sample_requests(run, traffic, seed)
    del pred
    free_device()
    checks, ok, other = judge.judge_run(run, picked, family, cfg, seed, device, pool)
    log(f"portbench: compared {sum(len(r['ids']) for r in picked)} images of {len(picked)} requests; "
        f"not compared: {other}")
    result = dict(correct=bool(ok and failed == 0), attempted=len(run.requests), failed=failed, metrics=metrics,
                  device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks


def latencies_ms(run: Run) -> List[float]:
    """Each request's latency from its due time; one that failed or never
    came back counts as missing, above any latency a run can see."""
    missing = (GRACE_S + run.window_s) * 1e3
    return [(r["done"] - r["due"]) * 1e3 if r.get("out") is not None else missing for r in run.requests]


def end_to_end(name: str, run: Run) -> Optional[float]:
    """The harness's own end-to-end metrics, on the host's clock."""
    if name == "eval_images_per_s":
        return sum(len(r["ids"]) for r in run.completed) / run.window_s
    if name == "serve_p95_ms":
        return percentile(latencies_ms(run), 95)
    raise KeyError(f"no end-to-end metric {name!r} in the harness")
