"""The yardstick's arithmetic: work counts at the paper's widths against
hand counts, the device's busy union and idle gaps, the open loop's
schedule and its latencies."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, peaks, trace
from portbench.work import int8_gemm, k1, k3, request

CONFIGS = harness.HERE / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_parity_request_at_batch_70_is_4_7e14_operations():
    ops = request.ops(_cfg("ladine_chestxray_parity_bf16"), 70)
    # by hand: 1000 eps calls of 5 members x 1400 rows: lin2 + lin3 2 x 2 x 4096^2,
    # lin1 2 x 4 x 4096, lin4 2 x 4096 x 2 a row; encoders 2 x 70 x 5 x
    # (150528 + 4096 + 4096) x 4096; the ViT's 5 blocks on 70 x 196 tokens and
    # the patch projection; 5 mapping MLPs of 150528 -> 4096 -> 2048 -> 128 -> 2
    chain = 1000 * 5 * 1400 * 2 * (2 * 4096 * 4096 + 4 * 4096 + 4096 * 2)
    encoders = 2 * 70 * 5 * (150528 + 4096 + 4096) * 4096
    t = 70 * 196
    vit = 2 * t * 768 * 768 + 5 * (2 * t * 768 * 2304 + 4 * 70 * 196 * 196 * 768 + 2 * t * 768 * 768
                                   + 2 * 2 * t * 768 * 3072)
    mlps = 5 * 2 * 70 * (150528 * 4096 + 4096 * 2048 + 2048 * 128 + 128 * 2)
    assert set(ops) == {"bf16"}
    assert ops["bf16"] == chain + encoders + vit + mlps
    assert 4.70e14 < ops["bf16"] < 4.74e14


def test_serving_chain_runs_2_35e13_int8_operations():
    cfg = _cfg("ladine_chestxray_serving_int8")
    ops = request.ops(cfg, 70)
    assert request.eps_calls(cfg) == 50
    assert ops["int8"] == 50 * 2 * 2 * 5 * 1400 * 4096 * 4096 == int8_gemm.chain_ops(5, 70, 20, 4096, 50)
    assert 2.34e13 < ops["int8"] < 2.36e13
    assert ops["fp32"] == 50 * 5 * 1400 * 2 * (4 * 4096 + 4096 * 2)


def test_k1_bounds_at_r_1400_and_160():
    lin2 = k1.eps_launches(5, 70, 20, 2, 4096, 2)["lin2"]
    assert lin2[0] == 2 * 5 * 1400 * 4096 * 4096
    assert peaks.least_seconds(*lin2[:1], "bf16", lin2[1]) == pytest.approx(0.2375e-3, rel=1e-3)
    lin2_b8 = k1.eps_launches(5, 8, 20, 2, 4096, 2)["lin2"]
    # bytes-bound: the weights, the rows in and out, the affine
    want = (5 * 160 * 4096 * 2 + 5 * 4096 * 4096) * 2 + 2 * 5 * 4096 * 4
    assert lin2_b8[1] == want
    assert peaks.least_seconds(lin2_b8[0], "bf16", lin2_b8[1]) == pytest.approx(want / 3.35e12)


def test_k3_counts():
    ops, n_bytes = k3.launch(70, 196, 12, 64, 2)
    assert ops == 4 * 70 * 12 * 196 * 196 * 64 and n_bytes == 4 * 70 * 196 * 12 * 64 * 2


def test_union_counts_overlapping_kernels_once():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 3.0), ("d", 2.2, 2.4)]
    assert trace.union(ev) == [(0.0, 1.5), (2.0, 3.0)]
    assert trace.busy_seconds(ev) == pytest.approx(2.5)
    assert trace.gaps(ev, -1.0, 4.0) == [(-1.0, 0.0), (1.5, 2.0), (3.0, 4.0)]
    assert trace.busy_seconds(trace.clip(ev, 0.25, 2.1)) == pytest.approx(1.25 + 0.1)


@pytest.mark.parametrize("seconds,span", [(51.0, (36.0, 51.0)), (15.0, (0.0, 15.0)), (5.0, (0.0, 5.0))])
def test_trace_covers_the_end_of_the_window(seconds, span):
    assert trace.traced_span(seconds) == span


def test_idle_share_reader_and_gap_labels():
    read = harness.load_module("metrics", "idle_share.eval").read
    run = SimpleNamespace(device_events=[("k", 0.0, 1.0), ("k", 0.5, 3.0)], trace_window_s=4.0)
    assert read(run) == pytest.approx(25.0)
    labels = trace.label_gaps([(3.0, 4.0), (0.0, 0.1)], [("outer", 0.0, 10.0), ("inner", 3.2, 3.8)], 0.0)
    assert labels[0][0].startswith("inner") and labels[0][1] == pytest.approx(1.0)
    assert labels[1][0].startswith("outer")


def test_open_schedule_gives_every_seed_the_same_work():
    """The same requests in the same cyclic order, entered at the seed's
    own point."""
    tr = dict(rate_images_per_s=160.0, sizes=[1, 2], shares=[0.5, 0.5], pattern_seed=1)
    a, b = harness.open_schedule(tr, 51.0, 1), harness.open_schedule(tr, 51.0, 2**31 + 17)
    assert len(a) == len(b) == round(160 / 1.5 * 51)
    assert a != b and a[0][0] == b[0][0] == 0.0
    sizes_a, sizes_b = [s for _, s in a], [s for _, s in b]
    assert sum(sizes_a) == sum(sizes_b) == round(len(a) * 1.5)
    assert any(sizes_a[i:] + sizes_a[:i] == sizes_b for i in range(len(a)))  # one cycle, entered elsewhere
    assert a[-1][0] == pytest.approx(51.0, rel=0.05)


def test_open_schedule_lays_bursts_from_data():
    """On/off phases in the traffic file: no request in an off phase, twice
    the rate in an on phase of multiplier 2, and no phases the same
    schedule as one phase at multiplier 1."""
    tr = dict(rate_images_per_s=160.0, sizes=[1], shares=[1.0], pattern_seed=1)
    plain = harness.open_schedule(tr, 51.0, 3)
    assert harness.open_schedule(dict(tr, phases=[[51.0, 1.0]]), 51.0, 3) == pytest.approx(plain)
    bursts = harness.open_schedule(dict(tr, phases=[[2.0, 2.0], [2.0, 0.0]]), 51.0, 3)
    due = np.array([d for d, _ in bursts])
    assert len(bursts) == round(160 * 2 * (12 * 2 + 2))  # 12 cycles and the 13th's on phase
    assert not ((due % 4.0) > 2.0).any() and due.max() < 50.0
    assert np.diff(np.sort(due)).min() >= 0


def test_a_trace_with_nothing_in_it_is_no_trace():
    t = trace.DeviceTrace(51.0)
    with pytest.raises(trace.NoTrace, match="never started"):
        t.require()
    t.t0 = 1.0
    with pytest.raises(trace.NoTrace, match="no device activity"):
        t.require()
    t.events = [("k", 1.0, 2.0)]
    with pytest.raises(trace.NoTrace, match="marker"):
        t.require()
    t.aligned = True
    t.require()


def test_a_run_without_a_trace_prints_no_result(monkeypatch, capsys):
    """run.py turns a traced run whose trace is empty into an exit code
    and no result line."""
    import torch

    import ladine_tpu_torch.device
    from portbench import run

    def empty_trace(*args, **kwargs):
        tracer = trace.DeviceTrace(51.0)
        tracer.t0 = 0.0
        tracer.close()
        tracer.require()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ladine_tpu_torch.device, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(harness, "run_cell", empty_trace)
    rc = run.main(["--workload", "serving_eval_b70", "--seed", "1", "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0 and not out.out.strip() and "no device activity" in out.err


def test_latency_counts_from_the_due_time_and_failures_as_missing():
    run = harness.Run(None, None, None)
    run.window_s = 10.0
    run.requests = [dict(due=1.0, sent=1.5, done=1.75, out={}),  # sent late: the wait counts
                    dict(due=2.0, sent=2.0, done=2.1, out={}),
                    dict(due=3.0, sent=3.0, done=3.01, out=None, error="boom")]
    lat = harness.latencies_ms(run)
    assert lat[0] == pytest.approx(750.0) and lat[1] == pytest.approx(100.0)
    assert lat[2] == (harness.GRACE_S + 10.0) * 1e3 > max(lat[:2])
    assert harness.end_to_end("serve_p95_ms", run) == lat[2]


def test_percentile_is_nearest_rank():
    assert harness.percentile(list(range(1, 101)), 95) == 95
    assert harness.percentile([5.0], 95) == 5.0
