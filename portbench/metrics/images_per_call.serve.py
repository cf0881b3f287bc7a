"""Images a device call of the batcher: MicroBatcher.stats(), the real
images (not the padding) over its device calls in the window."""


def read(run):
    stats = run.batcher_stats
    if not stats or not stats["device_calls"]:
        return None
    return stats["images"] / stats["device_calls"]
