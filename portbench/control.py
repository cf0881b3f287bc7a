"""The judge's numbers on the program, on the configuration's control and
under planted faults, seed by seed, at a cell's own sizes: what each limit
is set from, and what it catches.

    python3 -m portbench.control --workload <cell> --seeds 12 --control-seeds 3 [--first 0]
    python3 -m portbench.control --workload <cell> --seeds 3 --fault <name> [--fault <name> ...]

For each seed it makes the cell's weights, builds the program, serves the
requests the harness would compare (a closed cell: as many of its calls as
``compare_rows`` asks for; an open cell: a short window of its traffic) and
reads the judge's numbers against the reference (the program's readings).
For the first ``--control-seeds`` seeds it then puts the configuration's
``control`` in the program's place on the same images and draws: the
reference at a lower precision (``{"reference_int_bits": n}``,
``{"reference_fp8": true}``). With ``--fault`` it reads, instead, the
program with each fault or probe of ``portbench/faults.py`` planted, and whether the
run would be correct under the configuration's limits. A fault's program
runs eagerly: the same kernels, without the CUDA graph whose capture would
take 10-15 s a fault. One JSON line a seed; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import faults, harness, judge


def serve(run, pred, family, cfg, traffic, pool, seed, device):
    """The requests of ``run`` that the harness would compare."""
    if traffic["kind"] == "closed":
        b = traffic["batch"]
        for j in range(-(-traffic["compare_rows"] // b)):
            row0 = (j * b) % len(pool)
            out = pred.predict(pool[row0:row0 + b], noise=family.noise(cfg, b, seed, j, device))
            run.requests.append(dict(index=j, ids=list(range(row0, row0 + b)), out=family.outputs(out)))
    else:
        harness.open_loop(run, pred.predict, family, cfg, traffic, pool, seed, 5.0, device)


def readings(spec, name: str, seed: int, with_control: bool, device):
    cell, cfg, traffic = harness.find_cell(spec, name)
    family = harness.load_module("families", cfg["family"])
    run = harness.Run(cell, cfg, traffic)
    weights = family.make_weights(cfg, seed, device)
    pool = family.image_pool(cfg, traffic["pool"], seed, device)
    pred = family.build(cfg, weights, device)
    t0 = time.perf_counter()
    serve(run, pred, family, cfg, traffic, pool, seed, device)
    serve_s = time.perf_counter() - t0
    picked = judge.sample_requests(run, traffic, seed)
    ids, draws = judge.compared_rows(run, picked, family, cfg, seed, device)
    program = judge.stack([r["out"] for r in picked])
    del pred, weights
    harness.free_device()
    t1 = time.perf_counter()
    ref = family.reference(cfg, seed, pool[ids], draws, device)
    ref_s = time.perf_counter() - t1
    line = dict(workload=name, seed=seed, rows=len(ids), serve_s=serve_s, reference_s=ref_s,
                program=judge.gaps(program, ref))
    if with_control:
        ctl = cfg["control"]
        line["control"] = judge.gaps(family.as_outputs(family.reference(
            cfg, seed, pool[ids], draws, device, int_bits=ctl.get("reference_int_bits"),
            fp8=ctl.get("reference_fp8", False))), ref)
    line["ref_var_median"] = float(sorted(ref["var"][range(len(ids)), ref["vote"]])[len(ids) // 2])
    line["ref_probs_max"] = float(ref["probs"].max())
    harness.free_device()
    return line


def fault_readings(spec, name: str, seed: int, names, device, base=harness.HERE):
    """The judge's numbers with each fault of ``names`` planted in turn, on
    one seed's weights; the reference runs once a set of compared rows."""
    cell, cfg, traffic = harness.find_cell(spec, name, base)
    family = harness.load_module("families", cfg["family"], base)
    weights = family.make_weights(cfg, seed, device)
    pool = family.image_pool(cfg, traffic["pool"], seed, device)
    refs = []  # (ids, draws, the reference's outputs)
    line = dict(workload=name, seed=seed, faults={})
    for fault in names:
        run = harness.Run(cell, cfg, traffic, base)
        try:
            with faults.planted(fault):
                pred = family.build(cfg, weights, device)
                pred._graphs = None
                serve(run, pred, family, cfg, traffic, pool, seed, device)
                del pred
        except Exception as e:  # a fault that crashes the program fails its run
            line["faults"][fault] = dict(correct=False, error=repr(e))
            continue
        finally:
            harness.free_device()
        picked = judge.sample_requests(run, traffic, seed)
        ids, draws = judge.compared_rows(run, picked, family, cfg, seed, device)
        ref = next((r for i, d, r in refs if i == ids and torch.equal(d, draws)), None)
        if ref is None:
            ref = family.reference(cfg, seed, pool[ids], draws, device)
            refs.append((ids, draws, ref))
        checks, ok, other = judge.judge(judge.stack([r["out"] for r in picked]), ref, cfg["limits"])
        line["faults"][fault] = dict(correct=bool(ok), rows=len(ids), **{k: c["value"] for k, c in checks.items()},
                                     **other)
        harness.free_device()
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, action="append")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first", type=int, default=0, help="the first seed: seeds first .. first + seeds - 1, "
                                                         "each spread to a large number")
    p.add_argument("--fault", action="append", choices=sorted({**faults.FAULTS, **faults.PROBES}),
                   help="read the program with this fault planted instead (repeatable)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    from ladine_tpu_torch.device import card_line, resolve_device

    device = resolve_device("cuda")
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    print(json.dumps(dict(card=card_line(device))), flush=True)
    for name in args.workload:
        for i in range(args.first, args.first + args.seeds):
            seed = 2_000_000_000 + 7919 * i
            if args.fault:
                line = fault_readings(spec, name, seed, args.fault, device)
            else:
                line = readings(spec, name, seed, i - args.first < args.control_seeds, device)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
