"""K1's share of its roofline in the traced window, in %: the least time
of its launches (the larger of operations over the bf16 peak and bytes over
the memory bandwidth, lin1 and lin2/lin3 apart, portbench/work/k1.py) over
its device time, matched by K1's kernel names in the trace. The launches
are what kernels._build.launch_counts counted in the traced span: one lin1
and two lin2/lin3 an eps step."""

from portbench.peaks import least_seconds

PRECISION = {"bfloat16": "bf16"}


def read(run):
    k1 = run.work("k1")
    launches = run.launches.get("fused_linear_act", 0)
    if run.device_events is None or not launches or run.config["dtype"] not in PRECISION:
        return None
    device_s = sum(e - s for name, s, e in run.device_events if any(n in name for n in k1.NAMES))
    if not device_s:
        return None
    cfg = run.config
    shapes = k1.eps_launches(cfg["num_members"], run.traffic["batch"], cfg["mc_trials"], cfg["num_classes"],
                             cfg["feature_dim"], 2)
    p = PRECISION[cfg["dtype"]]
    step_s = sum(least_seconds(ops, p, n_bytes) for ops, n_bytes in shapes.values())
    return 100.0 * step_s * (launches / len(shapes)) / device_s
