"""The highest rate an open cell's traffic sustains: its mix at rising
rates, in one process on one predictor.

    python3 -m portbench.sweep --workload serving_open_poisson --rates 120 160 200 240 --seconds 20

At each rate (images/s) it runs the cell's open loop for ``--seconds`` and
prints one JSON line: the offered and completed rates, the median and 95th
percentile latency, the share of requests that came back, how late the
generator ran, and the backlog's growth: the median latency of the last
quarter of the requests over that of the first. A backlog that grows
through the run reads well above 1. The knee is the highest rate at which
it stays near 1; the cell runs at four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=3_000_000_019)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    from ladine_tpu_torch.device import card_line, resolve_device

    device = resolve_device("cuda")
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, cfg, traffic = harness.find_cell(spec, args.workload)
    family = harness.load_module("families", cfg["family"])
    pred = family.build(cfg, family.make_weights(cfg, args.seed, device), device)
    pool = family.image_pool(cfg, traffic["pool"], args.seed, device)
    for b in harness.warm_batches(traffic):
        for k in range(2):
            pred.predict(pool[:b], noise=family.noise(cfg, b, args.seed, k, device, stream=harness.WARM))
    print(json.dumps(dict(card=card_line(device), workload=args.workload)), flush=True)
    for rate in args.rates:
        run = harness.Run(cell, cfg, dict(traffic, rate_images_per_s=rate))
        start, end = harness.open_loop(run, pred.predict, family, cfg, run.traffic, pool, args.seed,
                                       args.seconds, device)
        run.window_s = args.seconds
        lat = harness.latencies_ms(run)
        done = run.completed
        q = max(1, len(lat) // 4)
        print(json.dumps(dict(
            rate_images_per_s=rate, requests=len(run.requests), came_back=len(done) / len(run.requests),
            completed_images_per_s=sum(len(r["ids"]) for r in done) / (end - start),
            p50_ms=harness.percentile(lat, 50), p95_ms=harness.percentile(lat, 95),
            generator_lag_ms_max=1e3 * max(r["sent"] - r["due"] for r in run.requests),
            backlog_growth=statistics.median(lat[-q:]) / statistics.median(lat[:q]),
            images_per_call=run.batcher_stats["images"] / max(run.batcher_stats["device_calls"], 1))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
