"""Seconds the serving API spent warming up and capturing its CUDA graphs
in set-up, summed over the cell's batch shapes (GraphCache.capture_seconds)."""


def read(run):
    return run.capture_seconds
