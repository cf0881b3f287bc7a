"""The port's MicroBatcher against ladine_tpu's, on the CPU.

The cases of tests/test_batching.py. Where a case is deterministic (one
caller at a time), both batchers run it on the same seeded numpy images and
must make the same device calls and return the same arrays; the concurrent
cases check what both promise (each caller gets its rows, fewer device calls
than requests), and the last runs the port's Predictor behind the batcher.
"""

import threading
import time

import numpy as np
import pytest

from ladine_tpu.infer.batching import MicroBatcher as JaxMicroBatcher
from ladine_tpu.infer.batching import _bucket as jax_bucket
from ladine_tpu_torch.infer.batching import MicroBatcher, _bucket


def _echo_fn(record):
    """A fake predict: each row's mean (so callers can check they got their
    rows back); records the batch sizes of the calls."""

    def fn(images):
        record.append(len(images))
        return {"mean": images.mean(axis=(1, 2, 3)), "probs": np.stack([images.mean(axis=(1, 2, 3))] * 2, -1)}

    return fn


@pytest.mark.parametrize("cap", [1, 8, 70])
def test_buckets_as_jax(cap):
    assert [_bucket(n, cap) for n in range(1, cap + 1)] == [jax_bucket(n, cap) for n in range(1, cap + 1)]
    assert MicroBatcher.bucket_sizes(cap) == JaxMicroBatcher.bucket_sizes(cap)
    assert [_bucket(n, 70) for n in (1, 2, 3, 5, 8, 9, 64, 65, 70)] == [1, 2, 4, 8, 8, 16, 64, 70, 70]


@pytest.mark.parametrize("n, cap, calls", [
    (3, 8, [4]),  # padded 3 -> bucket 4, the padding dropped
    (10, 4, [4, 4, 2]),  # an oversized request goes in chunks of the cap
    (8, 8, [8]),
])
def test_one_caller_as_jax(n, cap, calls):
    images = np.random.default_rng(n).random((n, 4, 4, 3)).astype(np.float32)
    results = {}
    for name, cls in (("port", MicroBatcher), ("jax", JaxMicroBatcher)):
        record = []
        b = cls(_echo_fn(record), max_batch=cap, max_wait_ms=1)
        results[name] = (b.predict(images), record, b.stats())
        b.close()
    (out, record, stats), (want, want_record, want_stats) = results["port"], results["jax"]
    assert record == want_record == calls
    assert stats == want_stats
    for k in want:
        np.testing.assert_array_equal(out[k], want[k])
    np.testing.assert_allclose(out["mean"], images.mean(axis=(1, 2, 3)), rtol=1e-6)


def test_concurrent_requests_coalesce():
    calls = []
    b = MicroBatcher(_echo_fn(calls), max_batch=16, max_wait_ms=200)
    results = {}

    def worker(val, n):
        results[val] = b.predict(np.full((n, 4, 4, 3), val, np.float32))

    threads = [threading.Thread(target=worker, args=(v, n)) for v, n in [(0.1, 2), (0.2, 3), (0.3, 1)]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v, n in [(0.1, 2), (0.2, 3), (0.3, 1)]:  # every caller got exactly its own rows
        assert results[v]["mean"].shape == (n,)
        np.testing.assert_allclose(results[v]["mean"], v, rtol=1e-6)
    assert len(calls) < 3, calls
    stats = b.stats()
    assert stats["requests"] == 3 and stats["images"] == 6
    b.close()


@pytest.mark.parametrize("cls", [MicroBatcher, JaxMicroBatcher], ids=["port", "jax"])
def test_error_reaches_every_caller_and_the_batcher_survives(cls):
    def boom(images):
        raise ValueError("bad batch")

    b = cls(boom, max_batch=4, max_wait_ms=1)
    for n in (1, 2):
        with pytest.raises(ValueError, match="bad batch"):
            b.predict(np.zeros((n, 4, 4, 3), np.float32))
    b.close()


@pytest.mark.parametrize("cls", [MicroBatcher, JaxMicroBatcher], ids=["port", "jax"])
def test_close_rejects_new_requests(cls):
    b = cls(_echo_fn([]), max_batch=4, max_wait_ms=1)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.predict(np.zeros((1, 4, 4, 3), np.float32))


def test_throughput_advantage_under_concurrency():
    """With a fixed cost per call, 8 concurrent single-image requests take
    about one call's time, not 8."""
    cost = 0.05
    calls = []

    def slow_fn(images):
        calls.append(len(images))
        time.sleep(cost)
        return {"mean": images.mean(axis=(1, 2, 3))}

    b = MicroBatcher(slow_fn, max_batch=32, max_wait_ms=100)
    t0 = time.time()
    threads = [threading.Thread(target=lambda: b.predict(np.zeros((1, 4, 4, 3), np.float32)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.time() - t0
    assert elapsed < 8 * cost, f"no coalescing: {elapsed:.3f}s, calls={calls}"
    b.close()


def test_microbatcher_with_the_port_predictor():
    """Concurrent callers through a tiny port Predictor on the CPU get
    well-formed rows from a coalesced call."""
    from ladine_tpu_torch.serve_http import build_demo_predictor

    predictor = build_demo_predictor(device="cpu", mc_trials=2, ddim_steps=5)
    b = MicroBatcher(predictor.predict, max_batch=8, max_wait_ms=100)
    imgs = np.random.default_rng(0).random((3, 16, 16, 3)).astype(np.float32)
    results = {}
    ths = [threading.Thread(target=lambda i=i: results.update({i: b.predict(imgs[i:i + 1])}))
           for i in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for i in range(3):
        assert results[i]["probs"].shape == (1, 2) and np.isfinite(results[i]["probs"]).all()
        np.testing.assert_allclose(results[i]["probs"].sum(axis=-1), 1.0, rtol=1e-5)
        assert results[i]["majority_vote"].shape == (1,)
    assert b.stats()["device_calls"] < 3
    b.close()
