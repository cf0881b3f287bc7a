"""The padded share of the rows the batcher dispatched, in %: rows that
pad a call up to its bucket, over every row sent to the device, read from
the harness's wrapper around the batcher's predict_fn."""


def read(run):
    if not run.calls:
        return None
    return 100.0 * sum(c["pad"] for c in run.calls) / sum(c["rows"] for c in run.calls)
