"""The window's completed requests' operations, counted from the
configuration's shapes (portbench/work/request.py), each precision's part
over the card's dense peak for it, summed, over the window's seconds (less
what starting the trace took from it), in %."""

from portbench.peaks import OPS_PER_S


def read(run):
    done = run.completed
    if not done or not run.window_s:
        return None
    request = run.work("request")
    seconds = 0.0
    for rec in done:
        ops = request.ops(run.config, len(rec["ids"]))
        seconds += sum(n / OPS_PER_S[p] for p, n in ops.items())
    return 100.0 * seconds / (run.window_s - run.trace_stall_s)
