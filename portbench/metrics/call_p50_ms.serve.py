"""The median host time of one device call of the batcher (copy-in,
graph replay, copy-out), in ms, from the harness's wrapper."""

import statistics


def read(run):
    if not run.calls:
        return None
    return 1e3 * statistics.median(c["t1"] - c["t0"] for c in run.calls)
