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
   the port). K1 is timed at lin2/lin3 (its ``mma`` body) and lin1 (its
   ``small_k`` body, a sub-record), beside ``torch.bmm`` on the lin2/lin3
   shapes as a GEMM-only yardstick (``cublas_gemm_ms``, never called by the
   port), and its ``mma`` body also at 20 and 1400 rows a member.
   The int8 kernels (K4 int8_linear_softplus in both schemes, K5a/K5b
   int8_eps_fused_l12/_l34) also print one layer of the ``torch._int_mm``
   int8 path as a yardstick, and their bounds use the int8 rate.
3. A small fp32 predictor on the card against the same predictor on the CPU
   (plain versions), same weights, same injected noise: the float chain,
   and the int8 chain through K4 and through K5.
4. The serving path at full width: ViT-B/16 guidance + 5 mapping MLPs + 5
   linear-arch members (random weights from a seeded generator, drawn on
   the card), the parity preset (1000-step ancestral chain, 20 MC trials),
   3 requests of batch 8. Checks finite outputs, probs rows summing to 1,
   votes in range, and the launch counts: fused_linear_act 3 x 1000 and
   flash_attention 5 per request. Then one request through the default
   DDIM-50 sampler, the stages of one parity request (guidance heads,
   member encoders, reverse chain) and a torch.profiler trace of one parity
   request (device time by kernel, device busy share). Then, on the same
   modules, one batch-8 request each at the int8 operating points
   ``serving``, ``fast``, ``serving`` + ``use_int8_pallas`` (K4, 100
   launches) and + ``pallas_fuse_ends`` (K5a and K5b, 50 each), each with
   the same checks, exact launch counts, its stages, peak memory and trace.

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
INT8_OP_PER_S = 1979e12  # dense int8 tensor cores
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
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


def bound(tensors, *work):
    """The least time (ms) the card could take for a call that reads each of
    ``tensors`` (inputs and outputs) once and does ``work``, pairs of (number
    of operations, the card's peak rate for their type), and which of the
    two bounds it."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, sum(n / rate for n, rate in work)
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
    from ladine_tpu_torch.kernels import fused_linear

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16, dev = torch.bfloat16, "cuda"
    M, R, F_ = 5, 20 * BATCH, 4096
    tol = 2e-2  # bf16 output rounding (2^-8 relative) + fp32 sums in another order
    entries = []

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device=dev).uniform_(lo, hi, generator=g).to(dtype)

    # K1 at lin2/lin3 (K = N = 4096, the mma body), with and without the
    # gate, and lin1 (K = 4, the small_k body)
    h = rnd(M, R, F_, lo=0.0, hi=2.0, dtype=bf16)
    w = rnd(M, F_, F_, lo=-F_**-0.5, hi=F_**-0.5, dtype=bf16)
    a, c = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    f = rnd(M, R, F_, dtype=bf16)
    y_in = rnd(M, R, 4, lo=0.0, hi=1.0, dtype=bf16)
    w1 = rnd(M, 4, F_, lo=-0.5, hi=0.5, dtype=bf16)
    k1 = {}
    for label, args in (("lin2/lin3", (h, w, a, c, None)), ("lin2 + gate", (h, w, a, c, f)),
                        ("lin1", (y_in, w1, a, c, f))):
        x_, w_, _, _, m_ = args
        out = K.fused_linear_act(*args)
        torch.cuda.synchronize()
        err = compare(f"fused_linear_act {label} {tuple(x_.shape)}x{tuple(w_.shape)} "
                      f"body={fused_linear.plan(x_.dtype, x_.shape[-1], F_, True)[0]}",
                      out, K.fused_linear_act_plain(*args), tol)
        ms = cuda_ms(lambda: K.fused_linear_act(*args), 20)
        plain_ms = cuda_ms(lambda: K.fused_linear_act_plain(*args), 5)
        b_ms, b_by = bound((*args, out), (2 * M * R * x_.shape[-1] * F_, BF16_FLOP_PER_S))
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        k1[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         shape=f"x{tuple(x_.shape)} w{tuple(w_.shape)} bf16")
    # yardstick, never called by the port: the GEMM alone (no epilogue) in cuBLAS
    cublas_gemm_ms = cuda_ms(lambda: torch.bmm(h, w), 20)
    print(f"    yardstick: torch.bmm {tuple(h.shape)}x{tuple(w.shape)} (cuBLAS, GEMM only) "
          f"{cublas_gemm_ms:.4f} ms")
    # the mma body at other row counts (batch 1 and batch 70 of the JAX bench):
    # how its time follows the x re-reads (rows) against the weight stream (fixed)
    rows_ms, errs = {str(R): k1["lin2/lin3"]["ms"]}, [v["max_abs_err"] for v in k1.values()]
    for rows in (20, 1400):
        hx = rnd(M, rows, F_, lo=0.0, hi=2.0, dtype=bf16)
        args = (hx, w, a, c, None)
        out = K.fused_linear_act(*args)
        torch.cuda.synchronize()
        errs.append(compare(f"fused_linear_act lin2/lin3 at R={rows}", out, K.fused_linear_act_plain(*args), tol))
        rows_ms[str(rows)] = cuda_ms(lambda: K.fused_linear_act(*args), 20)
        b_ms, b_by = bound((*args, out), (2 * M * rows * F_ * F_, BF16_FLOP_PER_S))
        print(f"    ms={rows_ms[str(rows)]:.4f} bound_ms={b_ms:.4f} ({b_by})")
    # the lin2/lin3 shape carries nearly all of the path's work; lin1 rides as a sub-record
    entries.append(dict(
        name="fused_linear_act", route="cuda", source="ladine_tpu_torch/csrc/fused_linear.cu",
        replaces="ladine_tpu/kernels/fused_linear.py:66", library_ms=None, cublas_gemm_ms=cublas_gemm_ms,
        **k1["lin2/lin3"], gate_ms=k1["lin2 + gate"]["ms"], rows_ms=rows_ms, lin1=k1["lin1"]))
    entries[-1]["max_abs_err"] = max(errs)

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
    b_ms, b_by = bound((q, k, v, out), (4 * B * H * N * N * D, BF16_FLOP_PER_S))
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="flash_attention", route="cuda", source="ladine_tpu_torch/csrc/attention.cu",
        replaces="ladine_tpu/kernels/attention.py:54", max_abs_err=k3_err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        shape=f"q/k/v{(B, N, H, D)} bf16 strided"))
    return entries


def check_int8_kernels():
    """Phase 2, int8: K4 (both schemes), K5a and K5b against their plain
    versions at the int8 path's shapes, and the time of one layer of the
    ``torch._int_mm`` path (``kernels.int8``) as a yardstick."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(3)
    bf16, dev = torch.bfloat16, "cuda"
    M, R, F_, C = 5, 20 * BATCH, 4096, 2
    # the kernels and their plain versions pick the same int8 codes and sum
    # them exactly; h differs where softplus rounds apart, by at most a bf16
    # ulp (2^-8 relative); K5b's lin4 sums in fp32 atomics in no fixed order
    tol = 2e-2

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device=dev).uniform_(lo, hi, generator=g).to(dtype)

    w_q, w_scale = Q.quantize_weight(rnd(M, F_, F_, lo=-F_**-0.5, hi=F_**-0.5))
    colsum = w_q.sum(dim=1, dtype=torch.int32).float()
    a, c = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    s = (w_scale * a).contiguous()
    x_sym = rnd(M, R, F_, lo=-2.0, hi=2.0, dtype=bf16)  # lin2's input f * softplus(.) is signed
    x_zp = rnd(M, R, F_, lo=0.0, hi=2.0, dtype=bf16)  # lin3's input is a softplus output
    entries = []

    def timed(label, fn, plain, inputs, outs, work):
        got = fn()
        torch.cuda.synchronize()
        err = max(compare(f"{label} {o}", a_, b_, tol) for o, a_, b_ in zip(outs, got, plain()))
        ms = cuda_ms(fn, 50)
        plain_ms = cuda_ms(plain, 10)
        b_ms, b_by = bound((*inputs, *got), *work)
        return err, ms, plain_ms, b_ms, b_by

    # K4, symmetric (lin2) and zero-point (lin3)
    k4 = None
    for scheme, x, cs in (("symmetric", x_sym, None), ("zero-point", x_zp, colsum)):
        xf = x.float()
        xmax = (xf.amax(-1, keepdim=True) if cs is not None else xf.abs().amax(-1, keepdim=True)).contiguous()
        args = (x, xmax, w_q, s, c, cs)
        err, ms, plain_ms, b_ms, b_by = timed(
            f"int8_linear_softplus {scheme} x{tuple(x.shape)} w{tuple(w_q.shape)}",
            lambda: K.int8_linear_softplus(*args), lambda: K.int8_linear_softplus_plain(*args),
            args, ("h", "hmax"), [(2 * M * R * F_ * F_, INT8_OP_PER_S)])

        def int8_path_layer():  # one int8_eps layer: quantize + torch._int_mm + epilogue
            z = Q.int8_matmul(x, w_q, w_scale, cs) * a.unsqueeze(-2) + c.unsqueeze(-2)
            return Q.softplus(z).to(bf16)

        int8_path_ms = cuda_ms(int8_path_layer, 20)
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); yardstick: "
              f"one torch._int_mm-path layer (kernels.int8) {int8_path_ms:.4f} ms")
        if k4 is None:
            k4 = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                      int8_path_ms=int8_path_ms, shape=f"x{tuple(x.shape)} bf16, w{tuple(w_q.shape)} int8")
        else:
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            k4["zero_point_ms"] = ms
    entries.append(dict(
        name="int8_linear_softplus", route="cuda", source="ladine_tpu_torch/csrc/int8_linear.cu",
        replaces="ladine_tpu/kernels/int8_pallas.py:136", library_ms=None, **k4))

    # K5a: lin1 (K = 2C) + gate, then lin2
    f = rnd(M, R, F_, dtype=bf16)
    y_in = rnd(M, R, 2 * C, lo=0.0, hi=1.0, dtype=bf16)
    w1 = rnd(M, 2 * C, F_, lo=-0.5, hi=0.5, dtype=bf16)
    a1, c1 = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    args = (f, y_in, w1, a1, c1, w_q, s, c)
    err, ms, plain_ms, b_ms, b_by = timed(
        f"int8_eps_fused_l12 f{tuple(f.shape)} w2{tuple(w_q.shape)}", lambda: K.int8_eps_l12(*args),
        lambda: K.int8_eps_l12_plain(*args), args, ("h2", "hmax2"),
        [(2 * M * R * F_ * F_, INT8_OP_PER_S), (2 * M * R * 2 * C * F_, FP32_FLOP_PER_S)])
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="int8_eps_fused_l12", route="cuda", source="ladine_tpu_torch/csrc/int8_eps_fused.cu",
        replaces="ladine_tpu/kernels/int8_pallas.py:391", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"f{tuple(f.shape)} bf16, w2{tuple(w_q.shape)} int8"))

    # K5b: lin3 (zero-point) + lin4 (N = C)
    h2 = x_zp
    hmax2 = h2.float().amax(-1, keepdim=True).contiguous()
    w4 = rnd(M, F_, C, lo=-F_**-0.5, hi=F_**-0.5, dtype=bf16)
    args = (h2, hmax2, w_q, s, c, colsum, w4)
    err, ms, plain_ms, b_ms, b_by = timed(
        f"int8_eps_fused_l34 h2{tuple(h2.shape)} w3{tuple(w_q.shape)} w4{tuple(w4.shape)}",
        lambda: (K.int8_eps_l34(*args),), lambda: (K.int8_eps_l34_plain(*args),), args, ("out",),
        [(2 * M * R * F_ * F_, INT8_OP_PER_S), (2 * M * R * F_ * C, BF16_FLOP_PER_S)])
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="int8_eps_fused_l34", route="cuda", source="ladine_tpu_torch/csrc/int8_eps_fused.cu",
        replaces="ladine_tpu/kernels/int8_pallas.py:442", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"h2{tuple(h2.shape)} bf16, w3{tuple(w_q.shape)} int8, w4{tuple(w4.shape)}"))
    return entries


def check_small_against_cpu():
    """Phase 3: a small fp32 predictor, kernels on the card vs plain on the
    CPU: the float chain (K1), and the int8 chain through K4 and through
    K5 (use_int8_pallas, without and with pallas_fuse_ends)."""
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
    g_gpu, m_gpu = copy.deepcopy(g_cpu).cuda(), copy.deepcopy(m_cpu).cuda()
    # fp32 sums in another order, along a 50-step chain; in int8 they can
    # also flip a code at a rounding boundary (about 1e-3 of one eps value)
    for label, kw, tol in (("float (K1)", {}, 1e-3),
                           ("use_int8_pallas (K4)", dict(use_int8_pallas=True), 1e-2),
                           ("use_int8_pallas + pallas_fuse_ends (K5)",
                            dict(use_int8_pallas=True, pallas_fuse_ends=True), 1e-2)):
        outs = []
        for dev, g, m in (("cpu", g_cpu, m_cpu), ("cuda", g_gpu, m_gpu)):
            p = L.Predictor(guidance=g, model=m, sched=L.DiffusionSchedule.create("linear", 50, device=dev),
                            mc_trials=4, ddim_steps=0, device=dev, **kw)
            outs.append(p.predict(images, noise=noise))
        cpu, gpu = outs
        assert (cpu["majority_vote"] == gpu["majority_vote"]).all(), (label, cpu, gpu)
        for name in ("probs", "piw", "mc_variance"):
            err = abs(cpu[name] - gpu[name]).max()
            print(f"  small fp32 predictor {label}, card vs CPU: {name} max_abs_err={err:.3e} (tol {tol:g})")
            assert err <= tol, (label, name)


def run_full_width():
    """Phase 4: the serving path at full width: the parity preset, then
    one request at each int8 operating point. Returns each kernel's
    launches on its path: K1 and K3 over the parity requests, K4 in the
    use_int8_pallas request, K5a and K5b in the pallas_fuse_ends one."""
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
    stages(pred, batches[0], "parity")
    trace(pred, batches[0], "parity")
    for name, (_, _, path_kernels) in INT8_REQUESTS.items():
        counts = serve_int8(guidance, model, sched, batches[0], name)
        launches.update({k: counts[k] for k in path_kernels})
    return launches


# The int8 operating points of phase 4: preset, flags, and the launches of
# each kernel in one request. DDIM-50 makes 50 eps calls: K4 runs twice in
# each, K5a and K5b once; the guidance runs ViT blocks 0-4 (K3 5 times).
INT8_REQUESTS = {
    "serving": ("serving", {}, {}),
    "fast": ("fast", {}, {}),
    "serving + use_int8_pallas": ("serving", dict(use_int8_pallas=True), {"int8_linear_softplus": 100}),
    "serving + use_int8_pallas + pallas_fuse_ends": (
        "serving", dict(use_int8_pallas=True, pallas_fuse_ends=True),
        {"int8_eps_fused_l12": 50, "int8_eps_fused_l34": 50}),
}
KERNELS = ("fused_linear_act", "flash_attention", "int8_linear_softplus", "int8_eps_fused_l12",
           "int8_eps_fused_l34")


def serve_int8(guidance, model, sched, images, name):
    """One full-width request of batch 8 at an int8 operating point, on the
    same modules as the parity requests (quantization leaves them as they
    are); returns the launches of each kernel in that request."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K

    preset, flags, expected = INT8_REQUESTS[name]
    t0 = time.perf_counter()
    pred = L.Predictor.from_preset(preset, guidance=guidance, model=model, sched=sched, mc_trials=20, **flags)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    pred.predict(images[:1])  # warm-up at batch 1: cuBLAS's int8 GEMM pads its rows to 17
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.launch_counts.clear()
    t0 = time.perf_counter()
    out = pred.predict(images)
    dt = time.perf_counter() - t0
    counts = {k: K.launch_counts[k] for k in KERNELS}
    print(f"  {name} request: batch {BATCH}, DDIM-{pred.ddim_steps}, {dt * 1e3:.1f} ms "
          f"({BATCH / dt:.2f} img/s); resident int8 weights made in {quant_s:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    probs = out["probs"]
    assert probs.shape == (BATCH, 2) and all(np.isfinite(v).all() for v in out.values()), out
    assert abs(probs.sum(-1) - 1.0).max() < 1e-4, probs
    assert ((out["majority_vote"] >= 0) & (out["majority_vote"] < 2)).all(), out
    want = {k: expected.get(k, 0) for k in KERNELS}
    want["flash_attention"] = 5
    assert counts == want, (name, counts, want)
    stages(pred, images, name)
    trace(pred, images, name)
    del pred
    torch.cuda.empty_cache()
    return counts


def stages(pred, images, label):
    """Host-clock time of the stages of one request, each ended by a
    synchronize: the guidance heads, the member encoders, and the rest (the
    reverse chain and the aggregation), each through the predictor's own
    path (int8 heads and encoders where it has them)."""
    from ladine_tpu_torch.kernels.int8 import int8_encode, int8_mapping_heads

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        x = torch.as_tensor(images, device="cuda")
        x_flat = x.reshape(len(x), -1)
        if pred._qheads is not None:
            heads_ms = timed_ms(lambda: int8_mapping_heads(
                pred.guidance, pred.guidance.taps_subset(x, pred._idx), pred._idx, pred._qheads))
        else:
            heads_ms = timed_ms(lambda: pred.guidance.heads_subset(x, pred._idx))
        if pred._qenc is not None:
            enc_ms = timed_ms(lambda: int8_encode(pred.model, x_flat, pred._qenc))
        else:
            enc_ms = timed_ms(lambda: pred.model.encode(x_flat))
    total_ms = timed_ms(lambda: pred.predict(images))
    print(f"  stages of one {label} request: guidance heads {heads_ms:.1f} ms, member encoders "
          f"{enc_ms:.1f} ms, reverse chain + aggregation {total_ms - heads_ms - enc_ms:.1f} ms, "
          f"total {total_ms:.1f} ms")


def trace(pred, images, label, top: int = 8):
    """Where a request's device time goes: torch.profiler over one request,
    device time summed by kernel name, and the device's busy share of the
    request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(images)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  trace of one {label} request: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), idle {100 * (1 - busy_ms / wall_ms):.1f} %, "
          f"{sum(e.count for e in rows)} device launches")
    for src, tag in (("K1 fused_linear.cu", "fused_linear_"), ("K3 attention.cu", "attention_")):
        hits = [e for e in rows if tag in e.key]
        if hits:
            print(f"    {src}: {sum(e.self_device_time_total for e in hits) / 1e3:.2f} ms in "
                  f"{sum(e.count for e in hits)} launches")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  {e.key[:90]}")


def print_registers(logs):
    """Each kernel's registers and spills, from ptxas's report in the build
    logs: they set how many blocks share an SM."""
    for name, log in logs.items():
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function '" in line:
                kernel = line.split("'")[1]
            elif kernel and ("registers" in line or "spill" in line):
                print(f"    {name}.cu {kernel[:72]}: {line.split(':', 1)[-1].strip()}")


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
    logs = _build.build(sources)
    print(f"  built {sources} in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    print_registers(logs)

    print("== phase 2: kernels vs plain versions at the path's shapes (bf16)")
    entries = check_kernels() + check_int8_kernels()
    print("== phase 3: small fp32 predictor, card vs CPU")
    check_small_against_cpu()
    print("== phase 4: full-width serving path (parity, serving and fast presets)")
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
