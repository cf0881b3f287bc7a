#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ladine_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no failure is caught):

1. Environment and build: prints the card's name and power limit, builds
   every CUDA source of the port (one nvcc each, all started together).
2. Kernels against their plain PyTorch versions, on the card, at the shapes
   the serving path gives them, in bf16: max abs/rel error against the
   stated tolerance, the kernel's time, the plain version's time, the
   card's bound for the same work and, for attention, the time of
   ``torch.nn.functional.scaled_dot_product_attention`` (never called by
   the port).
3. A small fp32 predictor on the card against the same predictor on the CPU
   (plain versions), same weights, same injected noise.
4. The serving path at full width: ViT-B/16 guidance + 5 mapping MLPs + 5
   linear-arch members (random weights from a seeded generator, drawn on
   the card), the parity preset (1000-step ancestral chain, 20 MC trials),
   3 requests of batch 8. Checks finite outputs, probs rows summing to 1,
   votes in range, and the launch counts: fused_linear_act 3 x 1000 and
   flash_attention 5 per request. Then one request through the default
   DDIM-50 sampler, the stages of one parity request (guidance heads,
   member encoders, reverse chain) and a torch.profiler trace of one parity
   request (device time by kernel, device busy share).

It prints a JSON line of kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores
BATCH, REQUESTS = 8, 3


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Device time of one call, averaged over ``iters`` back-to-back calls.

    A spin kernel holds the stream while the host enqueues the calls, so the
    events time the device and not the Python wrapper's launch overhead."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 1_000_000)  # ~0.5 ms of cycles per call to enqueue
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(tensors, n_ops: float):
    """The least time (ms) the card could take for a call that reads each of
    ``tensors`` (inputs and output) once and does ``n_ops`` bf16 operations,
    and which of the two bounds it."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(label, out, ref, tol):
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    max_abs = diff.max().item()
    max_rel = (diff / ref.abs().clamp_min(1e-3)).max().item()
    ok = bool(torch.isfinite(out).all()) and bool((diff <= tol + tol * ref.abs()).all())
    print(f"  {label}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=atol {tol:g} + rtol {tol:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return max_abs


def check_kernels():
    """Phase 2: each kernel against its plain version at the path's shapes."""
    from ladine_tpu_torch import kernels as K

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16, dev = torch.bfloat16, "cuda"
    M, R, F_ = 5, 20 * BATCH, 4096
    tol = 2e-2  # bf16 output rounding (2^-8 relative) + fp32 sums in another order
    entries = []

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device=dev).uniform_(lo, hi, generator=g).to(dtype)

    # K1 at lin2/lin3 (K = N = 4096), with and without the gate, and lin1 (K = 4)
    h = rnd(M, R, F_, lo=0.0, hi=2.0, dtype=bf16)
    w = rnd(M, F_, F_, lo=-F_**-0.5, hi=F_**-0.5, dtype=bf16)
    a, c = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    f = rnd(M, R, F_, dtype=bf16)
    y_in = rnd(M, R, 4, lo=0.0, hi=1.0, dtype=bf16)
    w1 = rnd(M, 4, F_, lo=-0.5, hi=0.5, dtype=bf16)
    k1_err, k1 = 0.0, None
    for label, args in (("lin2/lin3", (h, w, a, c, None)), ("lin2 + gate", (h, w, a, c, f)),
                        ("lin1 (K=4) + gate", (y_in, w1, a, c, f))):
        x_, w_, _, _, m_ = args
        out = K.fused_linear_act(*args)
        torch.cuda.synchronize()
        k1_err = max(k1_err, compare(f"fused_linear_act {label} {tuple(x_.shape)}x{tuple(w_.shape)}",
                                     out, K.fused_linear_act_plain(*args), tol))
        ms = cuda_ms(lambda: K.fused_linear_act(*args), 20)
        plain_ms = cuda_ms(lambda: K.fused_linear_act_plain(*args), 5)
        b_ms, b_by = bound((*args, out), 2 * M * R * x_.shape[-1] * F_)
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        if k1 is None:  # the lin2/lin3 shape carries nearly all of the path's work
            k1 = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      shape=f"x{tuple(x_.shape)} w{tuple(w_.shape)} bf16")
    entries.append(dict(
        name="fused_linear_act", route="cuda", source="ladine_tpu_torch/csrc/fused_linear.cu",
        replaces="ladine_tpu/kernels/fused_linear.py:66", max_abs_err=k1_err, library_ms=None, **k1))

    # K3 on the strided q/k/v slices of a fused qkv projection
    B, N, H, D = BATCH, 196, 12, 64
    qkv = rnd(B, N, 3, H, D, lo=-2.0, hi=2.0, dtype=bf16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = K.flash_attention(q, k, v)
    torch.cuda.synchronize()
    k3_err = compare(f"flash_attention {(B, N, H, D)} bf16", out, K.flash_attention_plain(q, k, v), tol)
    ms = cuda_ms(lambda: K.flash_attention(q, k, v), 50)
    plain_ms = cuda_ms(lambda: K.flash_attention_plain(q, k, v), 20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    b_ms, b_by = bound((q, k, v, out), 4 * B * H * N * N * D)
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="flash_attention", route="cuda", source="ladine_tpu_torch/csrc/attention.cu",
        replaces="ladine_tpu/kernels/attention.py:54", max_abs_err=k3_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        shape=f"q/k/v{(B, N, H, D)} bf16 strided"))
    return entries


def check_small_against_cpu():
    """Phase 3: a small fp32 predictor, kernels on the card vs plain on the CPU."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch.models import init_random_

    gen = torch.Generator().manual_seed(2)
    g_cpu = L.SEViTGuidance(num_classes=2, num_members=3, vit_depth=3, img_size=32, patch_size=8,
                            embed_dim=64, num_heads=2, mlp_hidden_dims=(64, 32, 16), device="cpu")
    m_cpu = L.ConditionalModel(3, 32 * 32 * 3, 64, 64, 2, 51, device="cpu")
    init_random_(g_cpu, gen)
    init_random_(m_cpu, gen)
    images = torch.rand(4, 32, 32, 3, generator=gen).numpy()
    noise = torch.randn(50, 3, 4, 4, 2, generator=gen)
    outs = []
    for dev, g, m in (("cpu", g_cpu, m_cpu), ("cuda", copy.deepcopy(g_cpu), copy.deepcopy(m_cpu))):
        p = L.Predictor(guidance=g, model=m, sched=L.DiffusionSchedule.create("linear", 50, device=dev),
                        mc_trials=4, ddim_steps=0, device=dev)
        outs.append(p.predict(images, noise=noise))
    cpu, gpu = outs
    assert (cpu["majority_vote"] == gpu["majority_vote"]).all(), (cpu, gpu)
    for name in ("probs", "piw", "mc_variance"):
        err = abs(cpu[name] - gpu[name]).max()
        print(f"  small fp32 predictor, card vs CPU: {name} max_abs_err={err:.3e} (tol 1e-3)")
        assert err <= 1e-3, name  # fp32 sums in another order, along a 50-step chain


def run_full_width():
    """Phase 4: the parity-preset serving path at full width."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.models import init_random_

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    guidance = L.SEViTGuidance(device="cuda", dtype=torch.bfloat16)
    model = L.ConditionalModel(5, device="cuda", dtype=torch.bfloat16)
    init_random_(guidance, gen)
    init_random_(model, gen)
    sched = L.DiffusionSchedule.create("linear", 1000, 1e-4, 0.02, device="cuda")
    pred = L.Predictor.from_preset("parity", guidance=guidance, model=model, sched=sched, mc_trials=20)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in list(guidance.parameters()) + list(model.parameters()))
    print(f"  built on the card: {n_params / 1e9:.3f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    batches = [rng.random((BATCH, 224, 224, 3), dtype="float32") for _ in range(REQUESTS)]
    pred.predict(batches[0][:1])  # warm-up (cuBLAS/cuDNN handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.launch_counts.clear()
    for i, images in enumerate(batches):
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        out = pred.predict(images)
        dt = time.perf_counter() - t0
        d1 = K.launch_counts["fused_linear_act"] - before.get("fused_linear_act", 0)
        d3 = K.launch_counts["flash_attention"] - before.get("flash_attention", 0)
        print(f"  parity request {i}: batch {BATCH}, {dt * 1e3:.1f} ms "
              f"({BATCH / dt:.2f} img/s); launches fused_linear_act={d1} flash_attention={d3}")
        probs = out["probs"]
        assert probs.shape == (BATCH, 2) and all(np.isfinite(v).all() for v in out.values()), out
        assert abs(probs.sum(-1) - 1.0).max() < 1e-4, probs
        assert ((out["majority_vote"] >= 0) & (out["majority_vote"] < 2)).all(), out
        assert d1 == 3 * 1000, d1  # 999 scan steps + the final eps, 3 layers each
        assert d3 == 5, d3  # ViT blocks 0-4 of the tap path
    launches = dict(K.launch_counts)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    ddim = L.Predictor(guidance=guidance, model=model, sched=sched, mc_trials=20)  # DDIM-50, eta 1
    t0 = time.perf_counter()
    out = ddim.predict(batches[0])
    dt = time.perf_counter() - t0
    assert np.isfinite(out["probs"]).all()
    print(f"  DDIM-50 request: batch {BATCH}, {dt * 1e3:.1f} ms ({BATCH / dt:.2f} img/s)")
    stages(pred, batches[0])
    trace(pred, batches[0])
    return launches


def stages(pred, images):
    """Host-clock time of the stages of one parity request, each ended by a
    synchronize: the guidance heads, the member encoders, and the rest (the
    reverse chain and the aggregation)."""
    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        x = torch.as_tensor(images, device="cuda")
        heads_ms = timed_ms(lambda: pred.guidance.heads_subset(x, range(pred.model.members)))
        enc_ms = timed_ms(lambda: pred.model.encode(x.reshape(len(x), -1)))
    total_ms = timed_ms(lambda: pred.predict(images))
    print(f"  stages of one parity request: guidance heads {heads_ms:.1f} ms, member encoders "
          f"{enc_ms:.1f} ms, reverse chain + aggregation {total_ms - heads_ms - enc_ms:.1f} ms, "
          f"total {total_ms:.1f} ms")


def trace(pred, images, top: int = 8):
    """Where a parity request's device time goes: torch.profiler over one
    request, device time summed by kernel name, and the device's busy share
    of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(images)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  trace of one parity request: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), idle {100 * (1 - busy_ms / wall_ms):.1f} %")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this script runs only on an NVIDIA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ladine_tpu_torch")):
        return fail(f"the ladine_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, here)
    from ladine_tpu_torch.kernels import _build

    # full fp32 where fp32 is asked for: no TF32 in matmuls or the patch conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: environment and build")
    card = gpu_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = sorted(n[:-3] for n in os.listdir(_build.CSRC_DIR) if n.endswith(".cu"))
    _build.build(sources)
    print(f"  built {sources} in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")

    print("== phase 2: kernels vs plain versions at the path's shapes (bf16)")
    entries = check_kernels()
    print("== phase 3: small fp32 predictor, card vs CPU")
    check_small_against_cpu()
    print("== phase 4: full-width serving path (parity preset)")
    launches = run_full_width()
    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was never launched on the main path")

    print(json.dumps({"kernels": entries}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
