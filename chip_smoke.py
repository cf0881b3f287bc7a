#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ladine_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no failure is caught):

1. Environment and build: prints the card's name and power limit, builds
   every CUDA source of the port (one nvcc each, all started together).
2. Kernels against their plain PyTorch versions, on the card, at the shapes
   and dtypes the serving path gives them (bf16 weights and activations; the
   float32 features as K1 lin1's gate; float32 rows in the int8 kernels, as
   ``serving`` stores them): max abs/rel error against the
   stated tolerance, the kernel's time, the plain version's time, the
   card's bound for the same work and, for attention, the time of
   ``torch.nn.functional.scaled_dot_product_attention`` (never called by
   the port). K1 is timed at lin2/lin3 (its ``mma`` body) and lin1 (its
   ``small_k`` body, a sub-record), beside ``torch.bmm`` on the lin2/lin3
   shapes as a GEMM-only yardstick (``cublas_gemm_ms``, never called by the
   port), and its ``mma`` body also at 20 and 1400 rows a member.
   The int8 kernels (K4 int8_linear_softplus in both schemes, K5a/K5b
   int8_eps_fused_l12/_l34) also print one layer of the ``torch._int_mm``
   int8 path as a yardstick, and their bounds use the int8 rate; K4 is
   also timed at 20 and 1400 rows a member, and K5a's lin1 pass alone
   (a sub-record; its codes must equal the plain version's).
3. A small fp32 predictor on the card against the same predictor on the CPU
   (plain versions), same weights, same injected noise: the float chain,
   and the int8 chain through K4 and through K5.
4. The serving path at full width: ViT-B/16 guidance + 5 mapping MLPs + 5
   linear-arch members (random weights from a seeded generator, drawn on
   the card), the parity preset (1000-step ancestral chain, 20 MC trials).
   ``Predictor.predict`` replays one CUDA graph per batch shape
   (``infer/graphs.py``). A request of batch 8 runs through the eager
   serving program and through the graph on the same generator: the
   outputs must be equal exactly (K5: see ``K5_RTOL``), with
   both request times, a torch.profiler trace of each (device time by
   kernel and by source, busy share, device launches), the launch counts
   of each and the graph's capture seconds. Then 3 graphed requests of
   batch 8. Checks finite outputs, probs rows summing to 1, votes in
   range, and the launch counts: fused_linear_act 3 x 1000 and
   flash_attention 5 per request. Then one request through the default
   DDIM-50 sampler and the stages of one eager parity request (guidance
   heads, member encoders, reverse chain). Then, on the same modules, the
   eager and the graphed request at each int8 operating point ``serving``,
   ``fast``, ``serving`` + ``use_int8_pallas`` (K4, 100 launches) and +
   ``pallas_fuse_ends`` (K5a and K5b, 50 each), each with the same checks,
   exact launch counts, its stages, peak memory and traces.
5. The artifact and batching surface at full width, on the phase-4 modules:
   reference-layout state dicts exported from them and read back into fresh
   modules (``utils/torch_convert.py``), every tensor bit-equal; one parity
   request of batch 8 from the fresh modules, exactly equal to phase 4's
   first on the same generator (K1 3000, K3 5 launches); ``Predictor.save``
   (~12.6 GiB of bf16 in a temporary directory beside this script, deleted
   afterwards: it needs that much free disk) and ``Predictor.load`` at
   ``serving`` + ``use_int8_pallas`` + ``pallas_fuse_ends`` (K5a and K5b 50
   launches each, K3 5), with the seconds of each and the artifact's size;
   then a ``MicroBatcher(max_batch=8)`` in front of the loaded predictor,
   fed requests of 1, 3 and 4 images from three threads: each caller gets
   its own rows of fewer device calls than requests.
6. The AOT bundle at full width, on the phase-4 modules:
   ``Predictor.export_serving`` of the float predictor (the parity preset
   over the DDIM-50 chain: K1 150, K3 5 launches a request; the 1000-step
   chain's export took 205-343 s of host time) at batch 8 and of
   ``serving`` + ``use_int8_pallas`` +
   ``pallas_fuse_ends`` at ``MicroBatcher.bucket_sizes(8)`` (K5a and K5b
   50, K3 5), each into a directory beside this script (``_smoke_bundle``,
   deleted after its checks: ~12.6 GiB of free disk), with the export
   seconds per batch size, the bundle's size and the seconds of
   ``ExportedPredictor.load``. The bundle's batch-8 request must equal the
   live predictor's on the same generator (exactly; K5: ``K5_RTOL``); then a
   ``MicroBatcher`` in front of the loaded K5 bundle takes requests of 1,
   3 and 4 images from three threads.
7. Robust evaluation at full width, on the phase-4 modules:
   ``evaluate_ensemble`` over two batches of seeded images (8, then a
   ragged tail of 3) with every corruption on (noise 0.05, low resolution
   2, brightness 0.1, contrast 0.8, cover (0.05, 2), crop 0.1) and PGD on
   the ViT (eps 0.03, 40 steps, random start), at three operating points:
   (a) ``ddim_steps=0`` float (K1, K3), (b) DDIM-50 with
   ``use_int8_pallas`` (K4), (c) with ``pallas_fuse_ends`` too (K5a, K5b).
   Each runs twice on one pipeline: cold (each batch's first call warms up
   and captures its CUDA graph) and warm (replays). Per batch it prints the
   seconds of the corruptions, the attack and the sampling, and the
   report's seconds; it holds each kernel's launches exact (K3: 12 a
   forward of every attack step), checks finite samples and the report's
   keys, and runs ``temperature_search`` on the samples. For (a) a graphed
   batch's samples equal the eager program's on the same attacked images
   and draws, exactly. Then each of the 7 attacks once on ``vit_logits`` at
   batch 2, with its seconds and its exact K3 launches (CW cut to one
   binary-search round of 100 steps, ``CW_CUT``: at its reference 6 x 1000
   it took 169 s), and a trace of one attack step at batch 2 and 8. Phase 2 holds K3's backward (the plain VJP) with the
   kernel's forward against autograd of the plain version at the ViT's
   shape and times it at batch 8 and 30, beside its bound and
   ``scaled_dot_product_attention``'s forward and backward.

8. Training at full width (ViT-B/16 at 224, five mapping MLPs, members of
   data_dim 150528 and feature = hidden = 4096 over 1001 gates; random
   weights from a seed; nothing cut), on phase 4's bf16 guidance, batch 30,
   bf16 compute on float32 master parameters. (a) The full train step of
   one member conditioned on head 4 (the reference's per-member run), fp32
   Adam and EMA; (b) after freeing phase 4's member modules, all five
   members with ``lowmem`` (bf16 Adam moments and EMA): for each, 10 timed
   steps after a warm-up with ms a step, images/s, K3's 5 launches a step
   held exact, the bytes floor (40 P, lowmem 28 P a member) and its share of
   3.35 TB/s, peak memory and a trace of one more step (as for (e) and
   (f)). (c) After each first update: a finite loss,
   every parameter leaf and running statistic moved, steps 1, and the
   debiased EMA equal to the reference's read of the parameters, 0.999834
   of them (``ROADMAP.md`` §3 F4), to fp32: 4 ulps; bf16: one ulp.
   (d) The hand-off: (b)'s debiased EMA as a bf16 ``ConditionalModel``
   behind a ``parity`` ``Predictor``, one batch-8 request eager and graphed,
   equal, K1 3000 and K3 5 launches. (e) The ViT fine-tune (AdamW, fresh
   2-class head): K3 12 launches and its VJP 12 runs a step. (f) The five
   mapping MLPs on one tap forward (K3 5 a step), fp32 Adam. (g) Two joint
   steps at the widths of ``configs/synthetic_tiny.yml`` (K3 at D = 16).
   (h) ``examples/gmm_posterior.py`` at full strength (1500 steps, 100
   trials): every row's MAE below 0.1, each row's launches exact. The
   counts are cleared before the phase and every kernel must launch in it.
   Then, not counted, each kernel against its plain version at the shapes
   and dtypes phase 8 gave it: K3 at batch 30 and at (g)'s D = 16 (196 and
   197 tokens; 16 and 17), K1, K4, K5a and K5b on the GMM rows (4100 rows
   of width 64, float32).
9. The command-line pipeline at ``configs/synthetic224.yml``'s widths
   (those of phase 8), in process through each CLI's ``main(argv)``, on a
   two-class ``pathmnist.npz`` made from a seed (90 / 30 / 16 images of
   28x28 RGB, class 1 brighter, resized to 224), with the config built in
   code and written by the port's own YAML writer, all in ``_smoke_cli/``
   beside this script (~37 GiB at its largest, deleted at the end):
   ``train_transformer`` (1 epoch, fp32 ViT), ``train_mapping`` (1 epoch,
   five MLPs), ``assemble``, ``main --train`` (five members,
   ``optim.lowmem``, ``--light_ckpt``, ``--val_ddim 25``), ``main --test``
   from its checkpoint (DDIM-50, 20 trials, batch 8, ``--save_samples``),
   ``main --test --suite`` (noise, PGD, ``parity``, ``use_int8_pallas``, +
   ``pallas_fuse_ends``) and ``main --calib --cached_samples --tune_T``.
   Each run prints its seconds, images/s of training, peak GiB, bytes
   written and launches, held exact. Bars: finite losses, the best
   checkpoint named as the JAX runner names it, probs rows summing to 1,
   the calibration from the dump equal to ``temperature_search`` and
   ``tune_temperature_nll`` on the test's samples. Then, not counted, K3 in
   float32 at batch 30 and K1 at the validation's 30 rows a member against
   their plain versions (``check_cli_shapes``).
10. The rest of the single-card surface at full width (nothing cut from the
   paper's widths; random weights drawn on the card from seeds). (b) On
   phase 9's corpus before it is deleted, ``train_transformer`` for every
   other ``--model_arch`` at 224, batch 30, one epoch in float32:
   ``deit``, ``deit_distilled``, ``convit`` (base: 16 heads, GPSA in 10 of
   12 blocks), ``efficientnetv2`` (variant l), ``resnet18``, ``resnet50``,
   each with its seconds, images/s, peak GiB, bytes written and K3's
   launches and VJP runs held exact (DeiT 12 a forward, ConViT 2, the rest
   0). (a) F5: five guidance-free (``--no_cat_f_phi``) linear members
   behind phase 4's guidance (rebuilt from its seed): a ``parity`` request
   eager and graphed, equal exactly (K1 3000, K3 5), ``serving`` +
   ``use_int8_pallas`` (K4 100) and + ``pallas_fuse_ends`` (K5a, K5b 50,
   ``K5_RTOL``), then three train steps of one member (fp32 Adam and EMA)
   with ms a step and peak GiB. (c) An ``arch="simple"`` ``Predictor`` of
   five full-width members (150528 -> 300 -> 100 -> 4096): a ``parity``
   request eager and graphed, equal (K1 3000); then ``encode`` at batch 8
   for five ``resnet18``/``resnet50`` members on 224x224x3 and
   ``lenet``/``lenet5``/``fashioncnn`` ones on 28x28x1, each against the
   same model on the CPU. Then, not counted, K1 at K = 2, K5a's lin1 pass
   and K5a at Ci = 2, and K3 in float32, forward and VJP, at (30, 198, 12,
   64) and (30, 197, 16, 48) against their plain versions
   (``check_phase10_shapes``).
11. The mesh (``parallel/``) at full width: two ranks over ``gloo`` that
   share the one card (``nccl`` refuses two ranks on one device), spawned
   after phase 10 has freed its modules, each group with a two-minute
   timeout; weights from phase 4's seeds on each rank. (a) Serving on a
   (member 1, data 2) mesh at batch 8, each rank 4 images: ``parity``
   graphed, ``serving`` + ``use_int8_pallas`` and + ``pallas_fuse_ends``,
   each against the one-process request of the same generator made in this
   process before the spawn (votes equal; ``probs``, PIW, variance within
   rtol 1e-4, atol 1e-5), launches exact a rank (K1 3000, K3 5; K4 100; K5a
   and K5b 50), request ms a rank (two processes sharing one card: not a
   multi-card time). (c) ``evaluate_ensemble`` on that mesh, one batch of 8
   at ``fast`` with PGD (each rank attacks 4 images), samples against the
   one-process samples at (a)'s tolerance, K3 exact. (b) One full train
   step (heads 0 and 1: K3 2 a step) of two members from one state with
   injected draws: on (member 2, data 1) in fp32 Adam and EMA, and on
   (member 1, data 2) with ``fsdp_plan`` and ``lowmem``, each in bf16
   compute behind phase 4's guidance (every deployment config's dtype) and
   in float32 behind its float32 copy, each against the one-process step
   on strided probes of every leaf (``hold_step``). float32: losses rtol
   1e-5, parameters atol 2.1e-3, first moments 1e-3 of their leaf's
   largest (bfloat16 moments: or one bfloat16 step; not the biases before
   a BatchNorm, whose exact gradient is zero). bf16: a rank's GEMMs of
   other shapes (one member of two, 15 rows of 30) round otherwise, so the
   rank and the one process are each held against a float64 witness (the
   one-process step with its members computed in float64 behind the same
   bf16 guidance): losses within 2^-8 (one bf16 rounding unit) of it, and
   the rank's first moments no farther from it, leaf by leaf, than twice
   the one process's (floored at 2^-8 of the leaf's largest); parameters
   atol 2.1e-3 against one process. ms a step and peak GiB a rank. Then,
   not counted, K1, K3, K4, K5a and K5b against their plain versions at a
   rank's shapes (``check_phase11_shapes``).
12. The 10-class real-data path at ``configs/digits.yml``'s widths (32 px,
   patch 8, embed 48 over 4 heads of D = 12, depth 5, feature = hidden =
   64, T = 100, 5 members, 10 classes, MC 10) on the committed digits
   corpus, in ``_smoke_digits/`` beside the script (gitignored, deleted at
   the end): (a) ``examples/run_digits.py`` with its epochs cut to
   ``DIGITS_EPOCHS`` (stage 1 and stage 3; widths untouched), each step's
   launches exact (``digits_step_launches``), the calibration, the clean,
   EMA, FGSM and noise rows, the clean majority-vote accuracy at or above
   ``DIGITS_MV_BAR``; (b) the same members at ``serving``, +
   ``use_int8_pallas`` (K4) and + ``pallas_fuse_ends`` (K5a, K5b at C =
   10) through ``cli.main --test --suite``, each row's majority-vote
   accuracy within ``DIGITS_INT8_POINTS`` of the float row's; (c) the bf16
   path: a bf16 ``Predictor`` from (a)'s checkpoints (K1's lin1 at K = 20
   with the float32 gate, K3 at D = 12), graphed against eager at DDIM-25
   (exactly) and ``serving`` + K5 (rtol 1e-4), a bf16 ViT forward against
   the float32 one, one bf16 member step at 10 classes. Then, not counted,
   every kernel at the digits shapes against its plain version, with its
   time and bound (``check_phase12_shapes``).
13. The evidence pipeline at ``configs/synthetic224.yml``'s widths (those
   of phase 8) with Pillow's import blocked (``sys.modules["PIL"] =
   None``), in ``_smoke_results/`` beside the script (gitignored, deleted
   at the end): (b) ``examples/run_results.py`` on a synthetic corpus cut to
   ``RESULTS_CORPUS`` (one test and one validation batch of 70) with its
   epochs cut to ``RESULTS_EPOCHS`` and the ``--fast`` suite, each step's
   launches exact (``results_step_launches``), every report finite over its
   70 images, the EMA test's samples (``--save_samples`` added to that
   step) finite with probs rows summing to 1, then a second call that runs
   no step; (a) the corpus it wrote through ``data/png.py`` read back by
   ``load_split`` equal to the generator's pixels; (c)
   ``examples/profile_serving.py`` at batch 70 with the int8, K4, K5 and
   int8-encode rows, ``PROFILE_REPS`` reps, its launches exact
   (``profile_launches``). Then, not counted, K1 (lin1 and lin2/lin3), K3,
   K5a and K5b at the batch-70 shapes in bf16 and float32 against their
   plain versions (``check_phase13_shapes``).

It prints a JSON line of kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores
INT8_OP_PER_S = 1979e12  # dense int8 tensor cores
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
BATCH, REQUESTS = 8, 3
PARITY_SEED = 1234  # the generator of phase 4's first parity request, and of phase 5's
ARTIFACT_DIR = "_smoke_artifact"  # phase 5's Predictor.save, beside this script (gitignored)
BUNDLE_DIR = "_smoke_bundle"  # phase 6's export_serving, beside this script (gitignored)
EAGER_SEED = 77  # the generator of phase 4's eager-against-graph requests
OUTPUTS = ("probs", "majority_vote", "piw", "mc_variance")


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, spin: int = 1_000_000) -> float:
    """Device time of one call, averaged over ``iters`` back-to-back calls.

    A spin kernel holds the stream while the host enqueues the calls, so the
    events time the device and not the Python wrapper's launch overhead:
    ``spin`` cycles a call (1e6: ~0.5 ms) must outlast the host's time to
    enqueue one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * spin)
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

    # K1 at lin2/lin3 (K = N = 4096, the mma body), with and without a bf16
    # gate, and lin1 (K = 4, the small_k body) gated by the float32 features
    h = rnd(M, R, F_, lo=0.0, hi=2.0, dtype=bf16)
    w = rnd(M, F_, F_, lo=-F_**-0.5, hi=F_**-0.5, dtype=bf16)
    a, c = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    f = rnd(M, R, F_)
    y_in = rnd(M, R, 4, lo=0.0, hi=1.0, dtype=bf16)
    w1 = rnd(M, 4, F_, lo=-0.5, hi=0.5, dtype=bf16)
    k1 = {}
    for label, args in (("lin2/lin3", (h, w, a, c, None)), ("lin2 + gate", (h, w, a, c, f.to(bf16))),
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
                         shape=f"x{tuple(x_.shape)} w{tuple(w_.shape)} bf16"
                               + ("" if m_ is None else f", gate {str(m_.dtype)[6:]}"))
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
        shape=f"q/k/v{(B, N, H, D)} bf16 strided", backward=check_attention_backward(g)))
    return entries


def check_attention_backward(g):
    """K3's gradient at the full ViT's shape (B, 197, 12, 64): the kernel's
    forward, then the plain VJP (``flash_attention_vjp``), against autograd
    of ``flash_attention_plain`` (2e-2 bf16, 1e-4 fp32); the VJP's time in
    bf16 at batch 8 and at phase 8's batch 30, with its bound and the
    library yardstick (:func:`vjp_times`)."""
    from ladine_tpu_torch import kernels as K

    out = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        qkv = torch.empty(BATCH, 197, 3, 12, 64, device="cuda").uniform_(-2.0, 2.0, generator=g)
        qkv = qkv.to(dtype).requires_grad_(True)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        d_out = torch.empty(BATCH, 197, 12, 64, device="cuda").uniform_(-1.0, 1.0, generator=g).to(dtype)
        before = K.launch_counts["flash_attention"]
        (got,) = torch.autograd.grad(K.flash_attention(q, k, v), qkv, d_out)
        assert K.launch_counts["flash_attention"] == before + 1, "the grad-requiring forward ran no kernel"
        (want,) = torch.autograd.grad(K.flash_attention_plain(q, k, v), qkv, d_out)
        torch.cuda.synchronize()
        err = compare(f"flash_attention backward {(BATCH, 197, 12, 64)} {str(dtype)[6:]} (kernel forward, "
                      f"plain VJP) vs autograd of the plain version", got, want, tol)
        if dtype == torch.bfloat16:
            out = dict(max_abs_err=err, **vjp_times(g, BATCH, plain=True))
            out["batch30"] = vjp_times(g, 30)
        else:
            out["fp32_max_abs_err"] = err
    return out


def vjp_times(g, batch, plain=False):
    """K3's backward at (batch, 197, 12, 64) bf16 on a fused qkv's slices:
    the plain VJP's time, its bound (q, k, v, out and dO read, dq, dk and dv
    written; 5 products of 2 B H N^2 D at the bf16 rate), the library
    yardstick (``scaled_dot_product_attention`` forward and backward under
    autograd, never called by the port) and, with ``plain``, autograd of
    the plain version (its forward included)."""
    from ladine_tpu_torch import kernels as K

    n, h, d = 197, 12, 64
    qkv = torch.empty(batch, n, 3, h, d, device="cuda").uniform_(-2.0, 2.0, generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    d_out = torch.empty(batch, n, h, d, device="cuda").uniform_(-1.0, 1.0, generator=g).to(torch.bfloat16)
    ms = cuda_ms(lambda: K.flash_attention_vjp(q, k, v, d_out), 20)
    o = K.flash_attention(q, k, v)
    grads = K.flash_attention_vjp(q, k, v, d_out)
    b_ms, b_by = bound((q, k, v, o, d_out, *grads), (10 * batch * h * n * n * d, BF16_FLOP_PER_S))
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    dt = d_out.transpose(1, 2)
    # autograd's host time a call can pass 0.5 ms on a loaded host: a longer spin
    library_ms = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dt),
                         20, spin=8_000_000)
    out = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
               shape=f"q/k/v{(batch, n, h, d)} bf16 strided")
    line = (f"    backward (plain VJP) at batch {batch}: ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"library_ms(sdpa forward + backward)={library_ms:.4f}")
    if plain:
        qg = qkv.detach().requires_grad_(True)
        out["autograd_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
            K.flash_attention_plain(qg[:, :, 0], qg[:, :, 1], qg[:, :, 2]), qg, d_out), 10, spin=8_000_000)
        line += f"; autograd of the plain version (its forward included) {out['autograd_plain_ms']:.4f} ms"
    print(line)
    return out


def check_int8_kernels():
    """Phase 2, int8: K4 (both schemes), K5a and K5b against their plain
    versions at the int8 path's shapes and dtypes (float32 rows: the
    ``serving`` features are float32, and the int8 paths store their hidden
    rows in the features' dtype, as the JAX package does), and the time of
    one layer of the ``torch._int_mm`` path (``kernels.int8``) as a
    yardstick."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(3)
    rows, dev = torch.float32, "cuda"
    M, R, F_, C = 5, 20 * BATCH, 4096, 2
    # the kernels and their plain versions pick the same int8 codes and sum
    # them exactly; h differs where softplus rounds apart (fp32 rounding);
    # K5b's lin4 sums its column tiles in fp32 atomics in no fixed order
    tol = 1e-3

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device=dev).uniform_(lo, hi, generator=g).to(dtype)

    w_q, w_scale = Q.quantize_weight(rnd(M, F_, F_, lo=-F_**-0.5, hi=F_**-0.5))
    colsum = w_q.sum(dim=1, dtype=torch.int32).float()
    a, c = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    s = (w_scale * a).contiguous()
    x_sym = rnd(M, R, F_, lo=-2.0, hi=2.0, dtype=rows)  # lin2's input f * softplus(.) is signed
    x_zp = rnd(M, R, F_, lo=0.0, hi=2.0, dtype=rows)  # lin3's input is a softplus output
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
            return Q.softplus(z).to(rows)

        int8_path_ms = cuda_ms(int8_path_layer, 20)
        print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); yardstick: "
              f"one torch._int_mm-path layer (kernels.int8) {int8_path_ms:.4f} ms")
        if k4 is None:
            k4 = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                      int8_path_ms=int8_path_ms, shape=f"x{tuple(x.shape)} fp32, w{tuple(w_q.shape)} int8")
        else:
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            k4["zero_point_ms"] = ms
    # K4 (symmetric) at other row counts (batch 1 and batch 70 of the JAX
    # bench): the weight stream is fixed, x's re-reads and the work grow with R
    k4["rows_ms"], k4["rows_bound_ms"] = {str(R): k4["ms"]}, {str(R): k4["bound_ms"]}
    for n_rows in (20, 1400):
        x = rnd(M, n_rows, F_, lo=-2.0, hi=2.0, dtype=rows)
        args = (x, x.float().abs().amax(-1, keepdim=True).contiguous(), w_q, s, c, None)
        got = K.int8_linear_softplus(*args)
        torch.cuda.synchronize()
        k4["max_abs_err"] = max([k4["max_abs_err"]] + [
            compare(f"int8_linear_softplus symmetric at R={n_rows} {o}", a_, b_, tol)
            for o, a_, b_ in zip(("h", "hmax"), got, K.int8_linear_softplus_plain(*args))])
        k4["rows_ms"][str(n_rows)] = cuda_ms(lambda: K.int8_linear_softplus(*args), 50)
        b_ms, b_by = bound((*args, *got), (2 * M * n_rows * F_ * F_, INT8_OP_PER_S))
        k4["rows_bound_ms"][str(n_rows)] = b_ms
        print(f"    ms={k4['rows_ms'][str(n_rows)]:.4f} bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="int8_linear_softplus", route="cuda", source="ladine_tpu_torch/csrc/int8_linear.cu",
        replaces="ladine_tpu/kernels/int8_pallas.py:136", library_ms=None, **k4))

    # K5a: lin1 (K = 2C) + gate, then lin2
    f = rnd(M, R, F_, dtype=rows)
    y_in = rnd(M, R, 2 * C, lo=0.0, hi=1.0, dtype=rows)
    w1 = rnd(M, 2 * C, F_, lo=-0.5, hi=0.5, dtype=rows)
    a1, c1 = rnd(M, F_, lo=0.5, hi=1.5), rnd(M, F_, lo=-0.5, hi=0.5)
    # its lin1 pass alone: the same codes and max|h1| as the plain version, bit for bit
    lin1_args = (f, y_in, w1, a1, c1)
    xq, xmax1 = K.int8_lin1(*lin1_args)
    torch.cuda.synchronize()
    ref_q, ref_m = K.int8_lin1_plain(*lin1_args)
    codes_ok = torch.equal(xq, ref_q) and torch.equal(xmax1, ref_m)
    print(f"  int8_lin1 (K5a's lin1 pass) f{tuple(f.shape)} y_in{tuple(y_in.shape)}: int8 codes and "
          f"max|h1| {'equal' if codes_ok else 'DIFFER'} ({int((xq != ref_q).sum())} codes differ)")
    if not codes_ok:
        raise AssertionError("int8_lin1: the kernel's codes differ from its plain version's")
    lin1_b_ms, lin1_b_by = bound((*lin1_args, xq, xmax1), (2 * M * R * 2 * C * F_, FP32_FLOP_PER_S))
    lin1 = dict(ms=cuda_ms(lambda: K.int8_lin1(*lin1_args), 50),
                plain_ms=cuda_ms(lambda: K.int8_lin1_plain(*lin1_args), 10),
                bound_ms=lin1_b_ms, bound_by=lin1_b_by, max_abs_err=0.0,
                shape=f"f{tuple(f.shape)} y_in{tuple(y_in.shape)} fp32")
    print(f"    ms={lin1['ms']:.4f} plain_ms={lin1['plain_ms']:.4f} bound_ms={lin1_b_ms:.4f} ({lin1_b_by})")
    args = (f, y_in, w1, a1, c1, w_q, s, c)
    err, ms, plain_ms, b_ms, b_by = timed(
        f"int8_eps_fused_l12 f{tuple(f.shape)} w2{tuple(w_q.shape)}", lambda: K.int8_eps_l12(*args),
        lambda: K.int8_eps_l12_plain(*args), args, ("h2", "hmax2"),
        [(2 * M * R * F_ * F_, INT8_OP_PER_S), (2 * M * R * 2 * C * F_, FP32_FLOP_PER_S)])
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="int8_eps_fused_l12", route="cuda", source="ladine_tpu_torch/csrc/int8_eps_fused.cu",
        replaces="ladine_tpu/kernels/int8_pallas.py:391", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, lin1=lin1,
        shape=f"f{tuple(f.shape)} fp32, w2{tuple(w_q.shape)} int8"))

    # K5b: lin3 (zero-point) + lin4 (N = C)
    h2 = x_zp
    hmax2 = h2.float().amax(-1, keepdim=True).contiguous()
    w4 = rnd(M, F_, C, lo=-F_**-0.5, hi=F_**-0.5, dtype=rows)
    args = (h2, hmax2, w_q, s, c, colsum, w4)
    err, ms, plain_ms, b_ms, b_by = timed(
        f"int8_eps_fused_l34 h2{tuple(h2.shape)} w3{tuple(w_q.shape)} w4{tuple(w4.shape)}",
        lambda: (K.int8_eps_l34(*args),), lambda: (K.int8_eps_l34_plain(*args),), args, ("out",),
        [(2 * M * R * F_ * F_, INT8_OP_PER_S), (2 * M * R * F_ * C, FP32_FLOP_PER_S)])
    print(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    entries.append(dict(
        name="int8_eps_fused_l34", route="cuda", source="ladine_tpu_torch/csrc/int8_eps_fused.cu",
        replaces="ladine_tpu/kernels/int8_pallas.py:442", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"h2{tuple(h2.shape)} fp32, w3{tuple(w_q.shape)} int8, w4{tuple(w4.shape)} fp32"))
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
    eager_vs_graph(pred, batches[0], "parity", {"fused_linear_act": 3000, "flash_attention": 5})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.launch_counts.clear()
    for i, images in enumerate(batches):
        before = dict(K.launch_counts)
        gen = torch.Generator(device="cuda").manual_seed(PARITY_SEED) if i == 0 else None
        t0 = time.perf_counter()
        out = pred.predict(images, generator=gen)
        dt = time.perf_counter() - t0
        if i == 0:
            parity_out = out
        d1 = K.launch_counts["fused_linear_act"] - before.get("fused_linear_act", 0)
        d3 = K.launch_counts["flash_attention"] - before.get("flash_attention", 0)
        print(f"  parity request {i} (graph): batch {BATCH}, {dt * 1e3:.1f} ms "
              f"({BATCH / dt:.2f} img/s); launches fused_linear_act={d1} flash_attention={d3}")
        check_outputs(out, BATCH)
        assert d1 == 3 * 1000, d1  # 999 scan steps + the final eps, 3 layers each
        assert d3 == 5, d3  # ViT blocks 0-4 of the tap path
    launches = dict(K.launch_counts)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    ddim = L.Predictor(guidance=guidance, model=model, sched=sched, mc_trials=20)  # DDIM-50, eta 1
    ddim.predict(batches[0])  # captures the batch's graph
    t0 = time.perf_counter()
    out = ddim.predict(batches[0])
    dt = time.perf_counter() - t0
    assert np.isfinite(out["probs"]).all()
    print(f"  DDIM-50 request (graph): batch {BATCH}, {dt * 1e3:.1f} ms ({BATCH / dt:.2f} img/s)")
    del ddim
    stages(pred, batches[0], "parity")
    for name, (_, _, path_kernels) in INT8_REQUESTS.items():
        counts = serve_int8(guidance, model, sched, batches[0], name)
        launches.update({k: counts[k] for k in path_kernels})
    return launches, dict(guidance=guidance, model=model, sched=sched, images=batches[0],
                          parity_out=parity_out)


def generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def eager_request(pred, images, seed: int):
    """A request through the serving program run eagerly (what the graph
    captures), on the noise ``predict`` draws from a generator of ``seed``."""
    noise = torch.randn(pred._program.noise_shape(len(images)), generator=generator(seed), device="cuda")
    with torch.inference_mode():
        outs = pred._program(torch.as_tensor(images, device="cuda"), noise)
        return {k: o.cpu().numpy() for k, o in zip(OUTPUTS, outs)}


# K5b's lin4 adds its column tiles' sums with fp32 atomics in no fixed order
# (32 tiles at full width; one, so a fixed order, at N <= 128), so two eager
# runs of a full-width K5 request already differ (~1e-7 relative in one
# eps), and the 50-step chain carries that to the outputs: a K5 request is
# held to another within rtol 1e-4 (atol 1e-6) and equal votes, beside the
# spread of two eager runs.
K5_RTOL = 1e-4


def same_outputs(got, want, rtol: float) -> bool:
    """Equal outputs: exactly, or within ``rtol`` (atol 1e-6) with equal
    votes."""
    return all(np.array_equal(got[k], want[k]) if rtol == 0 or k == "majority_vote"
               else np.allclose(got[k], want[k], rtol=rtol, atol=1e-6) for k in want)


def spread(a, b) -> str:
    """The largest abs and relative difference of each float output."""
    return ", ".join(f"{k} {np.abs(a[k] - b[k]).max():.2e} / "
                     f"{(np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1e-6)).max():.2e}"
                     for k in ("probs", "piw", "mc_variance"))


def eager_vs_graph(pred, images, label, want, rtol: float = 0.0):
    """Phase 4: one request of batch 8 through the eager serving program
    and through ``predict``'s CUDA graph, on the same generator: equal
    outputs, each path's request time, trace and launch counts (``want``,
    each kernel's launches a request), and the capture seconds."""
    from ladine_tpu_torch import kernels as K

    want = {k: want.get(k, 0) for k in KERNELS}
    eager_request(pred, images, EAGER_SEED)  # warm-up
    torch.cuda.synchronize()
    # deltas, not a cleared count: a caller may be counting a whole phase
    before = {k: K.launch_counts[k] for k in KERNELS}
    t0 = time.perf_counter()
    eager = eager_request(pred, images, EAGER_SEED)
    eager_ms = (time.perf_counter() - t0) * 1e3
    eager_counts = {k: K.launch_counts[k] - before[k] for k in KERNELS}
    t0 = time.perf_counter()
    pred.predict(images, generator=generator(EAGER_SEED))  # warm-up and capture, then a replay
    first_ms = (time.perf_counter() - t0) * 1e3
    capture_s = list(pred._graphs.capture_seconds.values())[-1]
    before = {k: K.launch_counts[k] for k in KERNELS}
    t0 = time.perf_counter()
    graphed = pred.predict(images, generator=generator(EAGER_SEED))
    graph_ms = (time.perf_counter() - t0) * 1e3
    graph_counts = {k: K.launch_counts[k] - before[k] for k in KERNELS}
    equal = same_outputs(graphed, eager, rtol)
    print(f"  {label} request, batch {BATCH}: eager {eager_ms:.1f} ms, graph {graph_ms:.1f} ms "
          f"({BATCH / graph_ms * 1e3:.2f} img/s); first call {first_ms:.1f} ms of which warm-up and capture "
          f"{capture_s:.2f} s; outputs {'equal' if equal else 'DIFFER'}"
          f"{f' (rtol {rtol:g})' if rtol else ' (exactly)'}; launches eager {eager_counts}, graph {graph_counts}")
    if rtol:
        print(f"    max abs / rel difference, graph against eager: {spread(graphed, eager)}; "
              f"two eager runs: {spread(eager_request(pred, images, EAGER_SEED), eager)}")
    check_outputs(graphed, BATCH)
    assert equal, (label, spread(graphed, eager))
    assert eager_counts == want and graph_counts == want, (label, eager_counts, graph_counts, want)
    trace(lambda: eager_request(pred, images, EAGER_SEED), f"{label} eager")
    trace(lambda: pred.predict(images, generator=generator(EAGER_SEED)), f"{label} graph")
    return graphed, graph_counts


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

    preset, flags, expected = INT8_REQUESTS[name]
    t0 = time.perf_counter()
    pred = L.Predictor.from_preset(preset, guidance=guidance, model=model, sched=sched, mc_trials=20, **flags)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _, counts = eager_vs_graph(pred, images, name, {**expected, "flash_attention": 5},
                               rtol=K5_RTOL if pred.pallas_fuse_ends else 0.0)
    print(f"  {name}: DDIM-{pred.ddim_steps}; resident int8 weights made in {quant_s:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stages(pred, images, name)
    del pred
    torch.cuda.empty_cache()
    return counts


def run_artifact_surface(guidance, model, sched, images, parity_out):
    """Phase 5: reference state dicts, save and load, the batcher, on the
    phase-4 modules. Returns each kernel's launches over its two requests."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.infer.batching import MicroBatcher
    from ladine_tpu_torch.utils import torch_convert as TC

    bf16 = torch.bfloat16
    # 1. reference-layout state dicts (float32) -> fresh bf16 modules
    t0 = time.perf_counter()
    g = guidance  # the fresh modules take the originals' geometry
    fresh_g = L.SEViTGuidance(g.num_classes, g.num_members, g.vit_depth, g.img_size, g.patch_size, g.embed_dim,
                              g.num_heads, g.mlp_hidden_dims, device="cuda", dtype=bf16)
    fresh_g.load_state_dict(TC.guidance_from_reference(
        TC.export_vit(guidance), [TC.export_mapping_mlp(guidance, i) for i in range(guidance.num_members)]))
    fresh_m = L.ConditionalModel(model.members, model.data_dim, model.feature_dim, model.hidden_dim,
                                 model.y_dim, model.n_steps, device="cuda", dtype=bf16)
    fresh_m.load_state_dict(TC.members_from_reference(
        [TC.export_conditional_model(model, i) for i in range(model.members)]))
    torch.cuda.synchronize()
    n = bit_equal(fresh_g, guidance) + bit_equal(fresh_m, model)
    print(f"  reference state dicts (timm ViT, {guidance.num_members} Classifier heads, {model.members} "
          f"ConditionalModels, float32) -> fresh modules: {n} tensors bit-equal, "
          f"{time.perf_counter() - t0:.1f} s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 2. the same parity request as phase 4's first, from the fresh modules
    fresh = L.Predictor.from_preset("parity", guidance=fresh_g, model=fresh_m, sched=sched, mc_trials=20)
    fresh.predict(images, generator=generator(PARITY_SEED))  # captures the batch's graph
    K.launch_counts.clear()
    t0 = time.perf_counter()
    out = fresh.predict(images, generator=torch.Generator(device="cuda").manual_seed(PARITY_SEED))
    dt = time.perf_counter() - t0
    counts = {k: K.launch_counts[k] for k in KERNELS}
    assert counts == dict(dict.fromkeys(KERNELS, 0), fused_linear_act=3000, flash_attention=5), counts
    same = {k: bool(np.array_equal(out[k], parity_out[k])) for k in out}
    print(f"  parity request (graph) from the fresh modules: batch {BATCH}, {dt * 1e3:.1f} ms; outputs equal to "
          f"phase 4's on the same generator: {same}; launches {counts}")
    assert all(same.values()), same
    launches = dict(counts)

    # 3. save, load at serving + K5, one request
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ARTIFACT_DIR)
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        fresh.save(path)
        save_s = time.perf_counter() - t0
        files = sorted(os.listdir(path))
        size = sum(os.path.getsize(os.path.join(path, f)) for f in files)
        del fresh, fresh_g, fresh_m
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = L.Predictor.load(path, preset="serving", use_int8_pallas=True, pallas_fuse_ends=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    print(f"  Predictor.save {save_s:.1f} s, {size / 2**30:.2f} GiB in {files} (deleted after the load); "
          f"Predictor.load at serving + use_int8_pallas + pallas_fuse_ends (int8 weights made) {load_s:.1f} s")
    loaded.predict(images)  # captures the batch's graph
    torch.cuda.synchronize()
    K.launch_counts.clear()
    t0 = time.perf_counter()
    out = loaded.predict(images)
    dt = time.perf_counter() - t0
    counts = {k: K.launch_counts[k] for k in KERNELS}
    print(f"  loaded serving + K5 request (graph): batch {BATCH}, DDIM-{loaded.ddim_steps}, {dt * 1e3:.1f} ms; "
          f"launches {counts}")
    check_outputs(out, BATCH)
    assert counts == dict(dict.fromkeys(KERNELS, 0), flash_attention=5, int8_eps_fused_l12=50,
                          int8_eps_fused_l34=50), counts
    for k, v in counts.items():
        launches[k] += v

    # 4. a MicroBatcher in front of the loaded predictor, three callers at once
    serve_behind_batcher(loaded.predict, "the loaded predictor")
    return launches


def run_bundles(guidance, model, sched, images, **_):
    """Phase 6: the AOT bundle at full width, on the phase-4 modules: the
    float bundle (the parity preset at DDIM-50) at batch 8, then the
    serving + K5 bundle at the batcher's buckets behind a MicroBatcher.
    Returns each kernel's launches over the two bundles' batch-8 requests."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.infer import ExportedPredictor, MicroBatcher

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), BUNDLE_DIR)
    launches = dict.fromkeys(KERNELS, 0)
    cases = (
        # the float chain's round trip at DDIM-50: the 1000-step chain's export
        # took 205-343 s of host time (~20x the nodes)
        ("float DDIM-50", dict(preset="parity", ddim_steps=50, ddim_eta=1.0), (BATCH,),
         {"fused_linear_act": 3 * 50, "flash_attention": 5}, 0.0),
        ("serving + use_int8_pallas + pallas_fuse_ends",
         dict(preset="serving", use_int8_pallas=True, pallas_fuse_ends=True), MicroBatcher.bucket_sizes(BATCH),
         {"int8_eps_fused_l12": 50, "int8_eps_fused_l34": 50, "flash_attention": 5}, K5_RTOL),
    )
    for label, kw, sizes, want, rtol in cases:
        live = L.Predictor.from_preset(kw.pop("preset"), guidance=guidance, model=model, sched=sched,
                                       mc_trials=20, **kw)
        live.predict(images, generator=generator(PARITY_SEED))  # captures the batch's graph
        live_out = live.predict(images, generator=generator(PARITY_SEED))
        shutil.rmtree(path, ignore_errors=True)
        try:
            t0 = time.perf_counter()
            export_s = live.export_serving(path, batch_sizes=sizes)
            total_s = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
            program_mb = {b: os.path.getsize(os.path.join(path, "programs", f"serving_b{b}.pt2")) / 2**20
                          for b in sizes}
            del live
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            served = ExportedPredictor.load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(path, ignore_errors=True)
        print(f"  {label} bundle: export_serving {total_s:.1f} s (export and save of each program: "
              f"{ {b: round(v, 1) for b, v in export_s.items()} } s; programs "
              f"{ {b: round(v, 1) for b, v in program_mb.items()} } MiB), {size / 2**30:.2f} GiB on disk "
              f"(deleted after the load); ExportedPredictor.load {load_s:.1f} s")
        served.predict(images, generator=generator(PARITY_SEED))  # captures the batch's graph
        K.launch_counts.clear()
        t0 = time.perf_counter()
        out = served.predict(images, generator=generator(PARITY_SEED))
        dt = time.perf_counter() - t0
        counts = {k: K.launch_counts[k] for k in KERNELS}
        equal = same_outputs(out, live_out, rtol)
        print(f"  {label} bundle request (graph): batch {BATCH}, {dt * 1e3:.1f} ms; outputs "
              f"{'equal' if equal else 'DIFFER'} to the live predictor's on the same generator"
              f"{f' (rtol {rtol:g})' if rtol else ' (exactly)'}; launches {counts}")
        if rtol:
            print(f"    max abs / rel difference to the live request: {spread(out, live_out)}")
        check_outputs(out, BATCH)
        assert equal, (label, spread(out, live_out))
        assert counts == {k: want.get(k, 0) for k in KERNELS}, (label, counts, want)
        for k, v in counts.items():
            launches[k] += v
        if label != "float DDIM-50":
            serve_behind_batcher(served.predict, "the loaded serving + K5 bundle")
        del served
        torch.cuda.empty_cache()
    return launches


# Phase 7's operating points: label, EvalConfig flags, and the launches of
# each chain kernel a batch (K3: 5 for the heads, plus the attack's).
EVAL_POINTS = (
    ("(a) ddim_steps=0 float", dict(ddim_steps=0), {"fused_linear_act": 3000}),
    ("(b) DDIM-50 + use_int8_pallas", dict(ddim_steps=50, ddim_eta=1.0, use_int8_pallas=True),
     {"int8_linear_softplus": 100}),
    ("(c) DDIM-50 + use_int8_pallas + pallas_fuse_ends",
     dict(ddim_steps=50, ddim_eta=1.0, use_int8_pallas=True, pallas_fuse_ends=True),
     {"int8_eps_fused_l12": 50, "int8_eps_fused_l34": 50}),
)
EVAL_CORRUPT = dict(noise_std=0.05, low_resolution=2, brightness=0.1, contrast=0.8, cover=(0.05, 2), crop=0.1)
EVAL_BATCHES = (BATCH, 3)  # a batch and a ragged tail
VIT_DEPTH = 12  # K3 launches in one forward of the full ViT
PGD_FORWARDS = 40 + 1  # a gradient forward a step, then the success forward
# CW at its reference settings (6 x 1000 Adam steps) takes 169.14 s at
# batch 2 on an H100 80GB HBM3 at 700 W, above the 90 s this script allows
# it: it runs cut to one binary-search round of 100 steps
CW_CUT = dict(binary_search_steps=1, steps=100)
# each attack's ViT forwards (a gradient forward per step plus its success
# checks); CW reads success from the forward of its next step, steps + 1 a
# binary-search round, and one after the eps clip
ATTACK_FORWARDS = {"FGSM": 2, "PGD": 41, "BIM": 11, "LinfBIM": 11, "L2PGD": 51,
                   "CW": CW_CUT["binary_search_steps"] * (CW_CUT["steps"] + 1) + 1, "AUTOPGD": 3 + 2 * 99 + 1}


def run_evaluation(guidance, model, sched, **_):
    """Phase 7: ``evaluate_ensemble`` at full width at the three operating
    points, then each attack once. Returns each kernel's launches over the
    warm evaluations."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.infer import EvalConfig, compute_report, evaluate_ensemble, make_eval_pipeline
    from ladine_tpu_torch.infer import temperature_search

    rng = np.random.default_rng(7)
    batches = [(rng.random((b, 224, 224, 3), dtype="float32"), rng.integers(0, 2, b)) for b in EVAL_BATCHES]
    n = sum(EVAL_BATCHES)
    launches = dict.fromkeys(KERNELS, 0)
    for label, flags, chain in EVAL_POINTS:
        cfg = EvalConfig(mc_trials=20, attack_name="PGD", attack_eps=0.03, **EVAL_CORRUPT, **flags)
        t0 = time.perf_counter()
        pipe = make_eval_pipeline(guidance, model, sched, cfg)
        torch.cuda.synchronize()
        print(f"  {label}: pipeline made in {time.perf_counter() - t0:.1f} s")
        per_batch = {k: len(EVAL_BATCHES) * v for k, v in chain.items()}
        per_batch["flash_attention"] = len(EVAL_BATCHES) * (PGD_FORWARDS * VIT_DEPTH + 5)
        for run in ("cold", "warm"):
            K.launch_counts.clear()
            seconds = {}
            t0 = time.perf_counter()
            report = evaluate_ensemble(guidance, model, sched, batches, cfg, seconds=seconds,
                                       generator=torch.Generator().manual_seed(11), pipeline=pipe)
            wall = time.perf_counter() - t0
            counts = {k: K.launch_counts[k] for k in KERNELS}
            # a cold batch's sampling is the graph's eager warm-up, its capture, then a replay
            want = {k: 0 for k in KERNELS}
            for k, v in per_batch.items():
                heads_and_chain = v - (len(EVAL_BATCHES) * PGD_FORWARDS * VIT_DEPTH if k == "flash_attention" else 0)
                want[k] = v + (heads_and_chain if run == "cold" else 0)
            stages = "; ".join(
                f"batch {b}: corrupt {s['corrupt']:.3f} s, attack {s['attack']:.3f} s, sample {s['sample']:.3f} s"
                for b, s in zip(EVAL_BATCHES, seconds["batches"]))
            print(f"  {label}, {run}: {wall:.2f} s for {n} images ({stages}; report {seconds['report']:.3f} s); "
                  f"launches {counts}")
            assert counts == want, (label, run, counts, want)
            samples = report["samples"]
            assert samples.shape == (5 * 20, n, 2) and np.isfinite(samples).all(), samples.shape
            keys = sorted(compute_report(samples, report["labels"], cfg.temperature, num_members=5))
            assert sorted(report) == keys, (sorted(report), keys)
            if run == "warm":
                for k in KERNELS:
                    launches[k] += counts[k]
        t0 = time.perf_counter()
        t_best, e_best = temperature_search(samples, report["labels"])
        print(f"    report: majority-vote accuracy {report['majority_vote_accuracy']:.2f} %, ECE "
              f"{report['ece']:.4f}, NLL {report['nll']:.4f}, Brier {report['brier']:.4f}, per member "
              f"{report['per_member_mv_accuracy']}; temperature_search -> T {t_best:.4f} (ECE {e_best:.4f}) "
              f"in {time.perf_counter() - t0:.2f} s")
        if label.startswith("(a)"):
            images, labels = batches[0]
            x, noise = pipe.prepare(images, labels, torch.Generator().manual_seed(12))
            K.launch_counts.clear()
            eager = pipe.sample(x, noise, eager=True)
            eager_counts = {k: K.launch_counts[k] for k in KERNELS if K.launch_counts[k]}
            K.launch_counts.clear()
            graphed = pipe.sample(x, noise)
            graph_counts = {k: K.launch_counts[k] for k in KERNELS if K.launch_counts[k]}
            equal = torch.equal(graphed, eager)
            print(f"    batch {BATCH}, graphed samples against the eager program's on the same attacked images "
                  f"and draws: {'equal' if equal else 'DIFFER'} (exactly); launches eager {eager_counts}, "
                  f"graph {graph_counts}")
            assert equal, (graphed - eager).abs().max()
            assert eager_counts == graph_counts == {"fused_linear_act": 3000, "flash_attention": 5}
        del pipe
        torch.cuda.empty_cache()
    run_attacks(guidance)
    return launches


def run_attacks(guidance):
    """Each of the 7 attacks once on the full ViT at batch 2, eps 0.03 (CW
    cut, ``CW_CUT``): seconds, success, and exact K3 launches; then a trace
    of one attack step (the CE gradient through the ViT) at batch 8."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.attacks import ATTACKS, cw_l2, make_attack
    from ladine_tpu_torch.attacks.gradient import _ce_grad

    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.random((2, 224, 224, 3), dtype="float32"), device="cuda")
    with torch.no_grad():
        labels = torch.argmax(guidance.vit_logits(x), dim=-1)  # the clean predictions
    for name in ATTACKS:
        attack = make_attack(name, 0.03, guidance.vit_logits)
        if name == "CW":
            attack = lambda x, y, g: cw_l2(guidance.vit_logits, x, y, epsilon=0.03, **CW_CUT)  # noqa: E731
        torch.cuda.synchronize()
        K.launch_counts.clear()
        t0 = time.perf_counter()
        adv, success = attack(x, labels, torch.Generator(device="cuda").manual_seed(13))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n3 = K.launch_counts["flash_attention"]
        delta = (adv - x).flatten(1)
        settings = ("CUT to binary_search_steps=1, steps=100 from the reference 6 x 1000"
                    if name == "CW" else "the reference settings")
        print(f"  attack {name} ({settings}): batch 2, {dt:.2f} s; success {success.tolist()}; |delta| Linf {delta.abs().amax().item():.4f}, "
              f"L2 {delta.norm(dim=1).max().item():.4f}; flash_attention launches {n3}")
        assert torch.isfinite(adv).all() and adv.shape == x.shape
        assert n3 == ATTACK_FORWARDS[name] * VIT_DEPTH, (name, n3)
    for b in (2, BATCH):
        xb = torch.as_tensor(rng.random((b, 224, 224, 3), dtype="float32"), device="cuda")
        yb = torch.zeros(b, dtype=torch.int64, device="cuda")
        _ce_grad(guidance.vit_logits, xb, yb)
        trace(lambda: (_ce_grad(guidance.vit_logits, xb, yb), torch.cuda.synchronize()),
              f"attack step (CE gradient through the ViT) at batch {b}", top=10)


# Phase 8: training at the paper's widths (PERF.md §4), nothing cut; the
# joint step at the widths of configs/synthetic_tiny.yml (full width does
# not fit beside five members' state, and the reference leaves it off)
FULL_WIDTHS = dict(img=224, patch=16, embed=768, depth=12, heads=12, mlp=(4096, 2048, 128),
                   data_dim=224 * 224 * 3, feature=4096, hidden=4096, n_steps=1001)
TINY_WIDTHS = dict(img=32, patch=8, embed=32, depth=5, heads=2, mlp=(32, 16, 8),
                   data_dim=32 * 32 * 3, feature=32, hidden=32, n_steps=51)
TRAIN_BATCH, TRAIN_STEPS = 30, 10  # the reference's batch; timed steps after one warm-up
PER_MEMBER_HEAD = 4  # (a): the reference's per-member run of mapping head 4 (K3: ViT blocks 0-4)
# the analytic bytes floor of a member step (bench.py _train_hbm_fields):
# fwd 4P + bwd 4P + Adam/EMA state read and write 16P each (lowmem 10P each)
FLOOR_BYTES_PER_PARAM = {False: 40, True: 28}
GMM_STEPS, GMM_TRIALS = 1500, 100  # the JAX example's full strength
GMM_ROWS, GMM_WIDTH = 41 * GMM_TRIALS, 64  # the GMM rows: grid points x trials; feature = hidden
JOINT_BATCH = 16  # (g)'s batch
# the GMM rows' launches of each kernel: ancestral 100 eps calls, DDIM 5
# (tau 0, 25, 50, 74, 99), three K1 layers a call; K4 twice a call, K5a and
# K5b once; the int8 eps with bf16 rows runs torch._int_mm only
GMM_LAUNCHES = {
    "ancestral": {"fused_linear_act": 300},
    "ddim": {"fused_linear_act": 15},
    "int8_bf16": {},
    "pallas_int8": {"int8_linear_softplus": 10},
    "pallas_v2": {"int8_eps_fused_l12": 5, "int8_eps_fused_l34": 5},
}


def free_memory():
    gc.collect()
    torch.cuda.empty_cache()


def gib_now() -> str:
    return f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated"


def probes(tensors):
    """A strided sample of each tensor (about 2^20 elements), copied."""
    return {k: v.reshape(-1)[:: max(1, v.numel() >> 20)].clone() for k, v in tensors.items()}


def timed_steps(run_step, label, k3_per_step, vjp_per_step=None, warm_up=True, steps=TRAIN_STEPS):
    """``steps`` calls of ``run_step`` (after one warm-up call unless the
    caller made it), each synchronized: the host-clock ms of each, and K3's
    forward launches (and its VJP's runs) held exact a step."""
    from ladine_tpu_torch import kernels as K

    if warm_up:
        run_step()
    times = []
    for _ in range(steps):
        n3, nv = K.launch_counts["flash_attention"], K.vjp_runs["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert K.launch_counts["flash_attention"] - n3 == k3_per_step, (label, K.launch_counts["flash_attention"] - n3)
        if vjp_per_step is not None:
            assert K.vjp_runs["flash_attention"] - nv == vjp_per_step, (label, K.vjp_runs["flash_attention"] - nv)
    ms = float(np.mean(times))
    print(f"  {label}: {ms:.1f} ms a step (min {min(times):.1f}, max {max(times):.1f}; {steps} steps after "
          f"a warm-up), {TRAIN_BATCH / ms * 1e3:.1f} images/s; K3 launches {k3_per_step} a step"
          + (f", its VJP {vjp_per_step} a step" if vjp_per_step is not None else ""))
    return ms, out


def check_first_update(state, lowmem, before_params, before_stats, losses):
    """(c): after the first update the loss is finite, every parameter leaf
    and running statistic moved, each member's step is 1, and the debiased
    EMA gives the reference's read of the parameters, (1 - mu)_f32 / (1 -
    mu_f32) = 0.999834 of them (``train/ema.py``): to float32 rounding (4
    ulps, 2^-21 relative) for a float32 accumulator, within one bfloat16 ulp
    (2^-7 relative) for a bfloat16 one."""
    from ladine_tpu_torch.train import debias_scale

    mu = 0.9999
    read = float(np.float32(1.0 - mu)) / (1.0 - float(np.float32(mu)))

    assert torch.isfinite(losses).all(), losses
    assert state.step.tolist() == [1] * state.step.numel(), state.step
    still = [k for before, now in ((before_params, state.params), (before_stats, state.batch_stats))
             for k, v in probes(now).items() if torch.equal(v, before[k])]
    assert not still, f"did not move: {still}"
    bound = 2.0**-7 * (1 + 2.0**-20) if lowmem else 2.0**-21  # bf16: and the fp32 read's rounding
    scale = debias_scale(mu, state.step).tolist()
    worst = 0.0
    for k, e in state.ema.items():
        for m in range(e.shape[0]):  # a member at a time: the temporaries stay a leaf's
            p = state.params[k][m]
            err = (e[m].float() * scale[m]).sub_(p, alpha=read).abs_()
            mag = p.abs().mul_(read)
            assert (err <= bound * mag).all(), (k, m)
            worst = max(worst, err.div_(mag.clamp_min_(1e-30)).max().item())
            del err, mag
    print(f"    first update: losses {[round(v, 4) for v in losses.tolist()]}, all {len(before_params)} parameter "
          f"leaves and {len(before_stats)} running statistics moved, steps {state.step.tolist()}; debiased EMA "
          f"against {read:.6f} x the parameters: largest relative error {worst:.2e} (bound {bound:.2e})")


def train_members(guidance, sched, members, heads, lowmem, label, steps=TRAIN_STEPS, include_guidance=True):
    """(a) or (b): the full train step (the bf16 guidance's heads, then each
    member's update in bf16 compute) on a state of ``members`` members, its
    first update checked (c), then ``steps`` timed steps; members without
    the guidance concat with ``include_guidance=False`` (phase 10 (a))."""
    from ladine_tpu_torch.models import ConditionalModel
    from ladine_tpu_torch.train import create_member_states, make_full_train_step, make_optimizer

    W = FULL_WIDTHS
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(80 + members)
    compute = ConditionalModel(members, W["data_dim"], W["feature"], W["hidden"], 2, W["n_steps"],
                               guidance=include_guidance, device="meta", dtype=torch.bfloat16)
    tx = make_optimizer("Adam", 1e-3, lowmem=lowmem)
    state = create_member_states(compute, gen, tx, members, lowmem=lowmem, device="cuda")
    p_member = sum(v.numel() for v in state.params.values()) // members
    step = make_full_train_step(guidance, compute, tx, sched, 5, 2, head_indices=heads)
    images = torch.rand(TRAIN_BATCH, W["img"], W["img"], 3, generator=gen, device="cuda")
    labels = torch.randint(0, 2, (TRAIN_BATCH,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    print(f"  {label}: state of {members} member(s) built in {time.perf_counter() - t0:.1f} s, {p_member / 1e9:.4f} G "
          f"parameters a member, {gib_now()}")
    before_p, before_s = probes(state.params), probes(state.batch_stats)
    state, losses = step(state, images, labels, gen)
    torch.cuda.synchronize()
    check_first_update(state, lowmem, before_p, before_s, losses)
    # the first update was the warm-up
    ms, (state, losses) = timed_steps(lambda: step(state, images, labels, gen), label, max(heads) + 1,
                                      warm_up=False, steps=steps)
    assert torch.isfinite(losses).all(), losses
    floor = FLOOR_BYTES_PER_PARAM[lowmem] * p_member * members
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    print(f"    bytes floor {FLOOR_BYTES_PER_PARAM[lowmem]} x P x {members} = {floor / 1e9:.1f} GB a step, "
          f"{floor_ms:.2f} ms at 3.35 TB/s: {100 * floor_ms / ms:.1f} % of the step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    trace(lambda: (step(state, images, labels, gen), torch.cuda.synchronize()), f"{label} step", top=10)
    return state


def train_vit(guidance):
    """(e): the ViT fine-tune with a fresh 2-class head (AdamW lr 1e-4, wd
    0.1, StepLR(10, 0.5) at 100 steps an epoch, no clipping, the reference's),
    bf16 compute on float32 masters."""
    from ladine_tpu_torch.train import create_vit_state, make_optimizer, make_vit_train_step, step_decay

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(90)
    tx = make_optimizer("AdamW", step_decay(1e-4, 10, 0.5, 100), weight_decay=0.1, grad_clip=None)
    state = create_vit_state(guidance.vit, gen, tx, device="cuda")
    step = make_vit_train_step(guidance.vit, tx)
    images = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 2, (TRAIN_BATCH,), generator=gen, device="cuda")
    ms, (state, loss, acc) = timed_steps(lambda: step(state, images, labels), "(e) ViT fine-tune", VIT_DEPTH,
                                         VIT_DEPTH)
    assert torch.isfinite(loss) and int(state.step) == TRAIN_STEPS + 1, (loss, state.step)
    print(f"    loss {float(loss):.4f}, accuracy {float(acc):.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    trace(lambda: (step(state, images, labels), torch.cuda.synchronize()), "(e) ViT fine-tune step", top=8)


def train_mapping(guidance):
    """(f): the five mapping MLPs on one frozen-ViT tap forward (Adam, the
    reference's StepLR(20, 0.5), float32 state, bf16 compute)."""
    from ladine_tpu_torch.train import create_mapping_states, make_mapping_train_step, make_optimizer, step_decay

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(91)
    tx = make_optimizer("Adam", step_decay(1e-3, 20, 0.5, 100), grad_clip=None)
    t0 = time.perf_counter()
    states = create_mapping_states(guidance.mlps[0], gen, tx, 5, device="cuda")
    torch.cuda.synchronize()
    n = sum(v.numel() for v in states.params.values())
    print(f"  (f) mapping MLPs: 5 states built in {time.perf_counter() - t0:.1f} s, {n / 5e9:.4f} G parameters "
          f"each, {gib_now()}")
    step = make_mapping_train_step(guidance.vit, guidance.mlps[0], tx, 5)
    images = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 2, (TRAIN_BATCH,), generator=gen, device="cuda")
    ms, (states, losses, accs) = timed_steps(lambda: step(states, images, labels), "(f) mapping MLPs", 5)
    assert torch.isfinite(losses).all() and states.step.tolist() == [TRAIN_STEPS + 1] * 5, (losses, states.step)
    print(f"    losses {[round(v, 4) for v in losses.tolist()]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    trace(lambda: (step(states, images, labels), torch.cuda.synchronize()), "(f) mapping step", top=8)


def train_joint_tiny():
    """(g): two joint steps (the guidance's cross-entropy step, then the
    five members') at the widths of configs/synthetic_tiny.yml, bf16
    compute: K3 at D = 16. Each step runs the guidance's full forward twice
    (taps of 5 blocks and the 5-block classifier: 10 K3 launches each), the
    first under grad (10 VJP runs)."""
    from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
    from ladine_tpu_torch.ops import DiffusionSchedule
    from ladine_tpu_torch.train import create_member_states, make_joint_train_step, make_optimizer
    from ladine_tpu_torch import kernels as K

    W = TINY_WIDTHS
    gen = torch.Generator(device="cuda").manual_seed(92)
    geometry = dict(num_classes=2, num_members=5, vit_depth=W["depth"], img_size=W["img"],
                    patch_size=W["patch"], embed_dim=W["embed"], num_heads=W["heads"], mlp_hidden_dims=W["mlp"])
    masters = init_random_(SEViTGuidance(**geometry, device="cuda", dtype=torch.float32), gen)
    gparams = {k: v.detach() for k, v in masters.named_parameters()}
    gcompute = SEViTGuidance(**geometry, device="meta", dtype=torch.bfloat16)
    compute = ConditionalModel(5, W["data_dim"], W["feature"], W["hidden"], 2, W["n_steps"], device="meta",
                               dtype=torch.bfloat16)
    tx, aux = make_optimizer("Adam", 1e-3), make_optimizer("Adam", 1e-4)
    states = create_member_states(compute, gen, tx, 5, device="cuda")
    aux_state = aux.init(gparams)
    step = make_joint_train_step(gcompute, compute, tx, aux, DiffusionSchedule.create("linear", W["n_steps"] - 1,
                                                                                     device="cuda"), 5, 2)
    images = torch.rand(JOINT_BATCH, W["img"], W["img"], 3, generator=gen, device="cuda")
    labels = torch.randint(0, 2, (JOINT_BATCH,), generator=gen, device="cuda")
    k3 = 2 * (W["depth"] + 5)
    for i in range(2):
        n3, nv = K.launch_counts["flash_attention"], K.vjp_runs["flash_attention"]
        t0 = time.perf_counter()
        states, gparams, aux_state, aux_loss, losses = step(states, gparams, aux_state, images, labels, gen)
        torch.cuda.synchronize()
        d3, dv = K.launch_counts["flash_attention"] - n3, K.vjp_runs["flash_attention"] - nv
        print(f"  (g) joint step {i} (tiny widths): {(time.perf_counter() - t0) * 1e3:.1f} ms; guidance loss "
              f"{float(aux_loss):.4f}, member losses {[round(v, 4) for v in losses.tolist()]}; K3 launches {d3}, "
              f"its VJP {dv}")
        assert torch.isfinite(aux_loss) and torch.isfinite(losses).all()
        assert d3 == k3 and dv == W["depth"] + 5, (d3, dv)
    assert states.step.tolist() == [2] * 5 and int(aux_state["count"]) == 2


def gmm_full_strength():
    """(h): the GMM posterior check at full strength on the card: every
    row's MAE below 0.1 (the JAX example's bound), each row's launches
    exact."""
    from ladine_tpu_torch.examples.gmm_posterior import ROWS, run

    out = run(n_train_steps=GMM_STEPS, mc_trials=GMM_TRIALS, verbose=False, device="cuda")
    print(f"  (h) GMM posterior: trained {GMM_STEPS} steps in {out['train']['seconds']:.1f} s (loss "
          f"{out['train']['loss']:.4f})")
    for name in ROWS:
        row = out[name]
        launches = {k: v for k, v in row["launches"].items() if k in KERNELS}
        print(f"    {name}: MAE {row['mae']:.4f}, {row['seconds']:.2f} s, launches {launches}")
        assert row["mae"] < 0.1, (name, row["mae"])
        assert launches == GMM_LAUNCHES[name], (name, launches)
    return out


def check_training_shapes(entries):
    """After phase 8's counted run (these launches are not counted): each
    kernel against its plain version at the shapes and dtypes phase 8 gave
    it, at phase 2's tolerances (float32 K1 at 1e-4, the card tests'):
    K3's forward at the train steps' batch 30 and at (g)'s D = 16, on the
    taps' bare patches and the classifier's patches and cls token, bf16 on
    a fused qkv's slices; K1 on the GMM rows' float32 member (lin1: K = 4
    gated by the float32 features; lin2/lin3: 64 x 64); K4 (both schemes),
    K5a and K5b on the int8 GMM rows (float32 rows, since encode's features
    are float32, and int8 weights of width 64). Each entry's
    ``max_abs_err`` takes the largest error, and ``phase8`` lists them."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(8)
    by_name = {e["name"]: e for e in entries}

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    def held(name, label, got, want, tol):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(compare(f"{name} {label}", a, b, tol) for a, b in zip(got, want))
        by_name[name].setdefault("phase8", {})[label] = err
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    full, tiny = FULL_WIDTHS, TINY_WIDTHS
    for b, w in ((TRAIN_BATCH, full), (JOINT_BATCH, tiny)):
        patches = (w["img"] // w["patch"]) ** 2
        for n in (patches, patches + 1):  # the taps (bare patches), the classifier (and its cls token)
            shape = (b, n, w["heads"], w["embed"] // w["heads"])
            qkv = rnd(b, n, 3, *shape[2:], lo=-2.0, hi=2.0, dtype=torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            held("flash_attention", f"{shape} bf16", K.flash_attention(q, k, v), K.flash_attention_plain(q, k, v),
                 2e-2)
            if b == TRAIN_BATCH:
                print(f"    ms={cuda_ms(lambda: K.flash_attention(q, k, v), 50):.4f}")

    R, F_ = GMM_ROWS, GMM_WIDTH
    f, y_in = rnd(1, R, F_), rnd(1, R, 4, lo=0.0, hi=1.0)
    w1 = rnd(1, 4, F_, lo=-0.5, hi=0.5)
    a, c = rnd(1, F_, lo=0.5, hi=1.5), rnd(1, F_, lo=-0.5, hi=0.5)
    h = rnd(1, R, F_, lo=0.0, hi=2.0)
    w = rnd(1, F_, F_, lo=-F_**-0.5, hi=F_**-0.5)
    for label, args in ((f"GMM lin1 y_in{tuple(y_in.shape)} fp32, gate fp32", (y_in, w1, a, c, f)),
                        (f"GMM lin2/lin3 {tuple(h.shape)}x{tuple(w.shape)} fp32", (h, w, a, c, None))):
        held("fused_linear_act", label, K.fused_linear_act(*args), K.fused_linear_act_plain(*args), 1e-4)

    w_q, w_scale = Q.quantize_weight(w)
    colsum = w_q.sum(dim=1, dtype=torch.int32).float()
    s = (w_scale * a).contiguous()
    for scheme, x, cs in (("symmetric", rnd(1, R, F_, lo=-2.0, hi=2.0), None), ("zero-point", h, colsum)):
        xmax = (x.amax(-1, keepdim=True) if cs is not None else x.abs().amax(-1, keepdim=True)).contiguous()
        args = (x, xmax, w_q, s, c, cs)
        held("int8_linear_softplus", f"GMM {scheme} {tuple(x.shape)} fp32", K.int8_linear_softplus(*args),
             K.int8_linear_softplus_plain(*args), 1e-3)
    args = (f, y_in, w1, a, c, w_q, s, c)
    held("int8_eps_fused_l12", f"GMM f{tuple(f.shape)} fp32", K.int8_eps_l12(*args), K.int8_eps_l12_plain(*args), 1e-3)
    w4 = rnd(1, F_, 2, lo=-F_**-0.5, hi=F_**-0.5)
    args = (h, h.amax(-1, keepdim=True).contiguous(), w_q, s, c, colsum, w4)
    held("int8_eps_fused_l34", f"GMM h2{tuple(h.shape)} fp32, w4{tuple(w4.shape)}", K.int8_eps_l34(*args),
         K.int8_eps_l34_plain(*args), 1e-3)


def run_training(full):
    """Phase 8: training at full width on phase 4's guidance; returns each
    kernel's launches over the phase. Sub-phases (a)-(h) as the module
    docstring lists them; what one no longer needs is freed before the
    next, and each prints its peak memory."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.train import conditional_model_from_state

    guidance, sched, images = full["guidance"], full["sched"], full["images"]
    seconds = {}
    t0 = time.perf_counter()
    state = train_members(guidance, sched, 1, (PER_MEMBER_HEAD,), False,
                          f"(a) one member (head {PER_MEMBER_HEAD}), fp32 Adam and EMA")
    del state
    seconds["(a)"] = time.perf_counter() - t0
    full.pop("model")  # phase 4's bf16 member modules
    free_memory()
    print(f"  phase 4's member modules freed: {gib_now()}")
    t0 = time.perf_counter()
    state = train_members(guidance, sched, 5, tuple(range(5)), True,
                          "(b) five members, lowmem (bf16 Adam moments and EMA)")
    seconds["(b)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = conditional_model_from_state(state, use_ema=True, dtype=torch.bfloat16, device="cuda")
    del state
    free_memory()
    pred = L.Predictor.from_preset("parity", guidance=guidance, model=model, sched=sched, mc_trials=20)
    print(f"  (d) hand-off: (b)'s debiased EMA as a bf16 ConditionalModel in {time.perf_counter() - t0:.1f} s, "
          f"{gib_now()}")
    eager_vs_graph(pred, images, "(d) hand-off parity", {"fused_linear_act": 3000, "flash_attention": 5})
    del pred, model
    seconds["(c, d)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_vit(guidance)
    seconds["(e)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_mapping(guidance)
    seconds["(f)"] = time.perf_counter() - t0
    free_memory()
    t0 = time.perf_counter()
    train_joint_tiny()
    seconds["(g)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gmm_full_strength()
    seconds["(h)"] = time.perf_counter() - t0
    print(f"  phase 8 seconds by sub-phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {k: K.launch_counts[k] for k in KERNELS}


# Phase 9: the command-line pipeline at configs/synthetic224.yml's widths,
# in process through each CLI's main(argv), on a two-class corpus made from
# a seed (28x28 RGB, class-dependent brightness, read as PathMNIST and
# resized to 224 on the way in)
CLI_DIR = "_smoke_cli"  # beside this script (gitignored), deleted at the end
CLI_CORPUS = {"train": 90, "val": 30, "test": 16}
CLI_SEED = 9
CLI_TEST_BATCH = 8
CLI_DDIM, CLI_VAL_DDIM = 50, 25
# the suite's rows: EvalConfig overrides on top of --ddim 50, and each
# chain kernel's launches a batch (K3: 5 for the heads, plus the attack's)
CLI_SUITE = {
    "noise": ({"noise_std": 0.05}, {"fused_linear_act": 3 * CLI_DDIM}),
    "pgd": ({"attack_name": "PGD", "attack_eps": 0.03}, {"fused_linear_act": 3 * CLI_DDIM}),
    "parity": ({"ddim_steps": 0}, {"fused_linear_act": 3000}),
    "int8_pallas": ({"use_int8_pallas": True}, {"int8_linear_softplus": 2 * CLI_DDIM}),
    "int8_fused": ({"use_int8_pallas": True, "pallas_fuse_ends": True},
                   {"int8_eps_fused_l12": CLI_DDIM, "int8_eps_fused_l34": CLI_DDIM}),
}


def cli_config(root: str, dataroot: str) -> str:
    """configs/synthetic224.yml's widths (ViT-B/16 at 224, mapping MLPs
    150528 -> 4096 -> 2048 -> 128 -> 2, five linear members of feature =
    hidden = 4096, T = 1000, bf16), built in code and written with the
    port's own YAML writer; one epoch at batch 30."""
    from ladine_tpu_torch.config import Config

    cfg = Config()
    w = FULL_WIDTHS
    cfg.data.dataset, cfg.data.dataroot, cfg.data.num_classes = "PathMNIST", dataroot, 2
    m = cfg.model
    m.image_size, m.patch_size, m.embed_dim, m.vit_depth, m.num_heads = (w["img"], w["patch"], w["embed"],
                                                                         w["depth"], w["heads"])
    m.mlp_hidden_dims, m.feature_dim, m.hidden_dim, m.data_dim = w["mlp"], w["feature"], w["hidden"], w["data_dim"]
    m.dtype, m.ema_rate = "bfloat16", 0.997
    cfg.diffusion.timesteps, cfg.diffusion.num_members = w["n_steps"] - 1, 5
    t = cfg.training
    t.batch_size, t.n_epochs, t.warmup_epochs, t.validation_freq, t.logging_freq = TRAIN_BATCH, 1, 1, 1, 10
    cfg.sampling.batch_size = TRAIN_BATCH
    cfg.testing.batch_size, cfg.testing.mc_trials, cfg.testing.drop_last = 70, 20, False
    path = os.path.join(root, "synthetic224_cli.yml")
    cfg.save_yaml(path)
    back = Config.from_yaml(path).to_dict()
    assert back == cfg.to_dict(), "the YAML writer and reader disagree"
    return path


def cli_corpus(root: str) -> None:
    """pathmnist.npz: 90 train, 30 valid, 16 test images, 28x28 RGB uint8,
    class 1 brighter than class 0 (the runner's demo images), labels (N, 1)."""
    rng = np.random.default_rng(CLI_SEED)
    arrays = {}
    for split, n in CLI_CORPUS.items():
        labels = rng.integers(0, 2, n)
        images = (rng.random((n, 28, 28, 3)) * 0.2 + labels[:, None, None, None] * 0.6) * 255
        arrays[f"{split}_images"] = images.astype(np.uint8)
        arrays[f"{split}_labels"] = labels.reshape(-1, 1)
    np.savez(os.path.join(root, "pathmnist.npz"), **arrays)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def run_cli(label, main, argv, want, root, train_images=True):
    """One CLI run, in process: its seconds, its JSON result (the last line
    it prints), the peak GiB, the bytes it added under ``root``, and each
    kernel's launches, held to ``want`` exactly."""
    import contextlib
    import io

    from ladine_tpu_torch import kernels as K

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    before = dir_bytes(root)
    K.launch_counts.clear()
    vjp = K.vjp_runs["flash_attention"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    seconds = time.perf_counter() - t0
    assert rc == 0, (label, rc)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    counts = {k: K.launch_counts[k] for k in KERNELS if K.launch_counts[k]}
    line = (f"  {label}: {seconds:.1f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{(dir_bytes(root) - before) / 2**30:.2f} GiB written, launches {counts}")
    if train_images and "train_seconds" in result:
        line += (f", K3 VJP runs {K.vjp_runs['flash_attention'] - vjp}; training {result['train_images']} images "
                 f"in {result['train_seconds']:.2f} s, {result['train_images'] / result['train_seconds']:.1f} "
                 "images/s")
    print(line)
    assert counts == {k: v for k, v in want.items() if v}, (label, counts, want)
    return result, counts


def eval_launches(chain, batches: int, attack_forwards: int = 0):
    """A --test run's launches over ``batches`` batches of one shape: the
    first batch's sampling is the graph's eager warm-up, its capture, then
    a replay, so its heads and chain count twice."""
    want = {k: v * (batches + 1) for k, v in chain.items()}
    want["flash_attention"] = 5 * (batches + 1) + attack_forwards * VIT_DEPTH * batches
    return want


def run_cli_pipeline(then=None):
    """Phase 9: the README's three stages through the port's CLIs at full
    width, then --test, the --suite and --calib from the cached samples.
    ``then(root, data_args)`` runs on the phase's corpus before it is
    deleted (phase 10 (b)). Returns each kernel's launches over the phase
    and what ``then`` returned."""
    from ladine_tpu_torch.cli import assemble, main as cli_main, train_mapping, train_transformer
    from ladine_tpu_torch.infer import temperature_search, tune_temperature_nll

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, CLI_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    total = dict.fromkeys(KERNELS, 0)
    try:
        cfg_path = cli_config(root, root)
        cli_corpus(root)
        models, exp = os.path.join(root, "models"), os.path.join(root, "exp")
        w = FULL_WIDTHS
        data = ["--dataset", "PathMNIST", "--dataroot", root, "--preprocess", "grayscaled", "--device", "cuda",
                "--image_size", str(w["img"]), "--patch_size", str(w["patch"]), "--embed_dim", str(w["embed"]),
                "--depth", str(w["depth"]), "--num_heads", str(w["heads"])]
        steps = -(-CLI_CORPUS["train"] // TRAIN_BATCH)
        runs = []
        res, c = run_cli("train_transformer (1 epoch, ViT-B/16 fp32, AdamW)", train_transformer.main,
                         data + ["--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--eval_batch_size",
                                 str(TRAIN_BATCH), "--out", models],
                         {"flash_attention": VIT_DEPTH * (steps + 1)}, root)
        assert np.isfinite(res["last_loss"]), res
        runs.append(c)
        vit_ckpt = os.path.join(models, "vit_PathMNIST")
        res, c = run_cli("train_mapping (1 epoch, five MLPs fp32, Adam)", train_mapping.main,
                         data + ["--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--num_members", "5",
                                 "--vit_ckpt", vit_ckpt, "--out", models, "--mlp_hidden_dims",
                                 *map(str, w["mlp"])],
                         {"flash_attention": 5 * (steps + 1)}, root)
        assert len(res["best_val_accuracies"]) == 5 and np.isfinite(res["last_losses"]).all(), res
        runs.append(c)
        guidance = os.path.join(models, "guidance_PathMNIST")
        res, c = run_cli("assemble", assemble.main,
                         ["--vit_ckpt", vit_ckpt, "--mlp_ckpt_dir", os.path.join(models, "PathMNIST", "MLPs"),
                          "--out", guidance], {}, root)
        assert res["num_members"] == 5, res
        common = ["--config", cfg_path, "--exp", exp, "--device", "cuda"]
        res, c = run_cli("main --train (1 epoch, five members, lowmem, light checkpoint)", cli_main.main,
                         common + ["--doc", "train", "--train", "--guidance_ckpt", guidance, "--set",
                                   "optim.lowmem=true", "--light_ckpt", "--val_ddim", str(CLI_VAL_DDIM)],
                         {"flash_attention": 5 * (steps + 1), "fused_linear_act": 3 * CLI_VAL_DDIM}, root)
        assert np.isfinite(res["last_losses"]).all(), res
        runs.append(c)
        ckpt = res["best_ckpt_path"]
        from ladine_tpu_torch.utils import best_checkpoint_name, load_checkpoint_meta

        meta = load_checkpoint_meta(ckpt)
        assert os.path.basename(ckpt) == best_checkpoint_name("diffu_all", 0, 0, res["best_accuracy"]), ckpt
        assert meta["light"] and meta["lowmem"] and meta["ema_init"] == "zero" and "guidance_src" in meta, meta
        print(f"    best checkpoint {os.path.basename(ckpt)}: {dir_bytes(ckpt) / 2**30:.2f} GiB, guidance "
              f"referenced at {meta['guidance_src']['guidance_ckpt']}")
        batches = -(-CLI_CORPUS["test"] // CLI_TEST_BATCH)
        test = common + ["--diffusion_ckpt", ckpt, "--ddim", str(CLI_DDIM), "--mc_trials", "20", "--set",
                         f"testing.batch_size={CLI_TEST_BATCH}"]
        res, c = run_cli(f"main --test (DDIM-{CLI_DDIM}, 20 trials, batch {CLI_TEST_BATCH}, --save_samples)",
                         cli_main.main, test + ["--doc", "test", "--test", "--save_samples"],
                         eval_launches({"fused_linear_act": 3 * CLI_DDIM}, batches), root)
        runs.append(c)
        with open(os.path.join(exp, "logs", "test", "report.json")) as f:
            report = json.load(f)
        assert report["num_instances"] == CLI_CORPUS["test"] and report["num_samples"] == 100, report
        dump = np.load(os.path.join(exp, "logs", "test", "samples.npz"))
        assert dump["samples"].shape == (100, CLI_CORPUS["test"], 2) and np.isfinite(dump["samples"]).all()
        from ladine_tpu_torch.metrics import ensemble_confidence

        probs = ensemble_confidence(torch.from_numpy(dump["samples"]), report["temperature"])
        assert torch.allclose(probs.sum(-1), torch.ones(CLI_CORPUS["test"]), atol=1e-5), probs.sum(-1)
        print(f"    test report: majority-vote accuracy {report['majority_vote_accuracy']:.2f} %, ECE "
              f"{report['ece']:.4f}, per member {report['per_member_mv_accuracy']}; probs rows sum to 1 "
              f"(max |sum - 1| {float((probs.sum(-1) - 1).abs().max()):.2e})")
        suite_path = os.path.join(root, "suite.json")
        with open(suite_path, "w") as f:
            json.dump({name: o for name, (o, _) in CLI_SUITE.items()}, f)
        want = dict.fromkeys(KERNELS, 0)
        for name, (o, chain) in CLI_SUITE.items():
            row = eval_launches(chain, batches, PGD_FORWARDS if o.get("attack_name") == "PGD" else 0)
            for k, v in row.items():
                want[k] += v
        res, c = run_cli("main --test --suite (noise, PGD, parity, use_int8_pallas, + pallas_fuse_ends)",
                         cli_main.main, test + ["--doc", "suite", "--test", "--suite", suite_path], want, root)
        for name, row in res["rows"].items():
            print(f"    suite row {name}: {row}")
            assert all(np.isfinite(v) for v in row.values()), (name, row)
        runs.append(c)
        samples_path = os.path.join(exp, "logs", "test", "samples.npz")
        res, c = run_cli("main --calib --cached_samples --tune_T", cli_main.main,
                         common + ["--doc", "calib", "--calib", "--cached_samples", samples_path, "--tune_T"], {},
                         root)
        t_best, _ = temperature_search(dump["samples"], dump["labels"])
        t_nll = tune_temperature_nll(dump["samples"], dump["labels"])
        print(f"    calibrated temperature {res['calibrated_temperature']:.6f} (the test's samples through "
              f"temperature_search: {t_best:.6f}); NLL-tuned {res['nll_tuned_temperature']:.6f} "
              f"(tune_temperature_nll: {t_nll:.6f})")
        assert res["calibrated_temperature"] == t_best and res["nll_tuned_temperature"] == t_nll, res
        for c in runs:
            for k, v in c.items():
                total[k] += v
        print(f"  _smoke_cli/ at its largest: {dir_bytes(root) / 2**30:.2f} GiB")
        after = then(root, data) if then is not None else None
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total, after


def check_cli_shapes(entries):
    """After phase 9's counted run (not counted): each kernel against its
    plain version at the shapes and dtypes phase 9 gave it that phases 2
    and 8 did not: K3 in float32 (the stage-1 CLIs train the ViT in
    float32, as the JAX CLIs do) at batch 30, on the taps' bare patches and
    the classifier's patches and cls token; K1 in bf16 at the validation
    sampler's 30 rows a member (five members, one trial, lin1 gated by the
    float32 features, then lin2/lin3). Each entry's ``max_abs_err`` takes
    the largest error, and ``phase9`` lists them."""
    from ladine_tpu_torch import kernels as K

    g = torch.Generator(device="cuda").manual_seed(9)
    by_name = {e["name"]: e for e in entries}

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    def held(name, label, got, want, tol):
        torch.cuda.synchronize()
        err = compare(f"{name} {label}", got, want, tol)
        by_name[name].setdefault("phase9", {})[label] = err
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    w = FULL_WIDTHS
    patches = (w["img"] // w["patch"]) ** 2
    for n in (patches, patches + 1):
        qkv = rnd(TRAIN_BATCH, n, 3, w["heads"], w["embed"] // w["heads"], lo=-2.0, hi=2.0)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        held("flash_attention", f"{tuple(q.shape)} fp32", K.flash_attention(q, k, v),
             K.flash_attention_plain(q, k, v), 1e-4)
        print(f"    ms={cuda_ms(lambda: K.flash_attention(q, k, v), 50):.4f}")
    m, r, f_ = 5, TRAIN_BATCH, w["feature"]
    f = rnd(m, r, f_)
    y_in = rnd(m, r, 4, lo=0.0, hi=1.0, dtype=torch.bfloat16)
    w1 = rnd(m, 4, f_, lo=-0.5, hi=0.5, dtype=torch.bfloat16)
    a, c = rnd(m, f_, lo=0.5, hi=1.5), rnd(m, f_, lo=-0.5, hi=0.5)
    h = rnd(m, r, f_, lo=0.0, hi=2.0, dtype=torch.bfloat16)
    w2 = rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5, dtype=torch.bfloat16)
    for label, args in ((f"lin1 y_in{tuple(y_in.shape)} bf16, gate fp32", (y_in, w1, a, c, f)),
                        (f"lin2/lin3 {tuple(h.shape)}x{tuple(w2.shape)} bf16", (h, w2, a, c, None))):
        held("fused_linear_act", label, K.fused_linear_act(*args), K.fused_linear_act_plain(*args), 2e-2)


# Phase 10: the rest of the single-card surface at full width. (b) the
# stage-1 backbones through train_transformer, each --model_arch with its K3
# forward launches a forward and VJP runs a train step (convit_base: the two
# MHSA blocks after the ten GPSA ones; the others: none)
STAGE1_ARCHS = {"deit": 12, "deit_distilled": 12, "convit": 2, "efficientnetv2": 0, "resnet18": 0, "resnet50": 0}
F5_SEED = 10  # the guidance-free members' generator
ENCODER_ARCHS = {"resnet18": (224, 224, 3), "resnet50": (224, 224, 3), "lenet": (28, 28, 1),
                 "lenet5": (28, 28, 1), "fashioncnn": (28, 28, 1)}


def phase4_guidance():
    """Phase 4's bf16 guidance again: the same seeded generator, drawn first."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch.models import init_random_

    guidance = L.SEViTGuidance(device="cuda", dtype=torch.bfloat16)
    return init_random_(guidance, torch.Generator(device="cuda").manual_seed(0))


def run_stage1_backbones(root, data):
    """Phase 10 (b): ``train_transformer`` for every backbone but the ViT
    (phase 9's run) at 224, batch 30, one epoch in float32 on phase 9's
    corpus: seconds, images/s, peak GiB, bytes written and K3's launches
    and VJP runs, held exact. Returns the launches over the runs."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.cli import train_transformer

    steps = -(-CLI_CORPUS["train"] // TRAIN_BATCH)
    total = dict.fromkeys(KERNELS, 0)
    for arch, k3 in STAGE1_ARCHS.items():
        argv = data + ["--model_arch", arch, "--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--eval_batch_size",
                       str(TRAIN_BATCH), "--out", os.path.join(root, "models10")]
        if arch == "efficientnetv2":
            argv += ["--effnet_variant", "l"]
        vjp = K.vjp_runs["flash_attention"]
        res, counts = run_cli(f"(b) train_transformer --model_arch {arch}", train_transformer.main, argv,
                              {"flash_attention": k3 * (steps + 1)}, root)
        assert K.vjp_runs["flash_attention"] - vjp == k3 * steps, (arch, K.vjp_runs["flash_attention"] - vjp)
        assert np.isfinite(res["last_loss"]), res
        assert os.path.isdir(os.path.join(root, "models10", f"{arch}_PathMNIST")), arch
        for k, v in counts.items():
            total[k] += v
    return total


def run_f5(sched, images):
    """Phase 10 (a): five guidance-free (``--no_cat_f_phi``) linear members at
    full width behind phase 4's guidance: a parity request eager and
    graphed (equal exactly), + use_int8_pallas (K4) and + pallas_fuse_ends
    (K5a, K5b), then three train steps of one member (fp32 Adam and EMA).
    Returns each kernel's launches."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.models import init_random_

    K.launch_counts.clear()
    guidance = phase4_guidance()
    W = FULL_WIDTHS
    model = L.ConditionalModel(5, W["data_dim"], W["feature"], W["hidden"], 2, W["n_steps"], guidance=False,
                               device="cuda", dtype=torch.bfloat16)
    init_random_(model, torch.Generator(device="cuda").manual_seed(F5_SEED))
    assert model.lin1.linear.weight.shape == (5, 2, W["feature"])
    pred = L.Predictor.from_preset("parity", guidance=guidance, model=model, sched=sched, mc_trials=20)
    eager_vs_graph(pred, images, "(a) guidance=False parity", {"fused_linear_act": 3000, "flash_attention": 5})
    del pred
    for name in ("serving + use_int8_pallas", "serving + use_int8_pallas + pallas_fuse_ends"):
        serve_int8(guidance, model, sched, images, name)
    del model
    free_memory()
    train_members(guidance, sched, 1, (PER_MEMBER_HEAD,), False, "(a) one guidance-free member, fp32 Adam and EMA",
                  steps=3, include_guidance=False)
    free_memory()
    return {k: K.launch_counts[k] for k in KERNELS}


def run_encoder_archs(sched, images):
    """Phase 10 (c): an ``arch="simple"`` Predictor of five full-width
    members (150528 -> 300 -> 100 -> 4096) behind phase 4's guidance, a
    parity request eager and graphed (equal exactly); then ``encode`` at
    batch 8 for the conv archs' five members, each against the same model
    on the CPU (the plain versions, the same weights). Returns the
    launches."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.models import init_random_

    K.launch_counts.clear()
    W = FULL_WIDTHS
    guidance = phase4_guidance()
    model = L.ConditionalModel(5, W["data_dim"], W["feature"], W["hidden"], 2, W["n_steps"], device="cuda",
                               dtype=torch.bfloat16, arch="simple")
    init_random_(model, torch.Generator(device="cuda").manual_seed(11))
    pred = L.Predictor.from_preset("parity", guidance=guidance, model=model, sched=sched, mc_trials=20)
    eager_vs_graph(pred, images, "(c) arch simple parity", {"fused_linear_act": 3000, "flash_attention": 5})
    launches = {k: K.launch_counts[k] for k in KERNELS}
    del pred, model, guidance
    free_memory()
    rng = np.random.default_rng(12)
    for arch, shape in ENCODER_ARCHS.items():
        data_dim = int(np.prod(shape))
        model = L.ConditionalModel(5, data_dim, W["feature"], W["hidden"], 2, W["n_steps"], device="cuda",
                                   dtype=torch.bfloat16, arch=arch)
        init_random_(model, torch.Generator(device="cuda").manual_seed(13))
        x = torch.from_numpy(rng.random((BATCH,) + shape, dtype="float32"))
        with torch.inference_mode():
            model.encode(x.cuda())  # cuDNN's first call picks its algorithms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.encode(x.cuda())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            cpu = L.ConditionalModel(5, data_dim, W["feature"], W["hidden"], 2, W["n_steps"], device="cpu",
                                     dtype=torch.bfloat16, arch=arch)
            cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            want = cpu.encode(x)
        n_enc = sum(v.numel() for k, v in model.state_dict().items() if k.startswith("encoder_x.")) // 5
        tol = 1e-4 * float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        print(f"  (c) encode, arch {arch}: images {(BATCH,) + shape}, five members of {n_enc / 1e6:.2f} M encoder "
              f"parameters, {ms:.1f} ms on the card; against the CPU: max_abs_err={err:.3e} (tol {tol:.3e}) -> "
              f"{'ok' if err <= tol else 'FAIL'}")
        assert got.shape == (5, BATCH, W["feature"]) and bool(torch.isfinite(got).all()) and err <= tol, arch
        del model, cpu
        free_memory()
    return launches


def check_phase10_shapes(entries):
    """After phase 10's counted run (not counted): each kernel against its
    plain version at the shapes phase 10 gave it that earlier phases did
    not: K1 lin1 at K = 2 (y_t alone: bf16 rows of 4 bytes, the float32
    features as the gate), K5a's lin1 pass and K5a whole at Ci = 2, and K3
    in float32, forward and VJP, at DeiT-distilled's 198 tokens (12 heads
    of 64) and ConViT-base's 197 tokens of 16 heads of D = 48. Each entry's
    ``max_abs_err`` takes the largest error, and ``phase10`` lists them."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(10)
    by_name = {e["name"]: e for e in entries}

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    def held(name, label, got, want, tol):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(compare(f"{name} {label}", a, b, tol) for a, b in zip(got, want))
        by_name[name].setdefault("phase10", {})[label] = err
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    m, r, f_ = 5, 20 * BATCH, FULL_WIDTHS["feature"]
    f = rnd(m, r, f_)
    y_in = rnd(m, r, 2, lo=-2.0, hi=2.0, dtype=torch.bfloat16)
    w1 = rnd(m, 2, f_, lo=-0.7, hi=0.7, dtype=torch.bfloat16)
    a, c = rnd(m, f_, lo=0.5, hi=1.5), rnd(m, f_, lo=-0.5, hi=0.5)
    held("fused_linear_act", f"lin1 K = 2 y_in{tuple(y_in.shape)} bf16, gate fp32",
         K.fused_linear_act(y_in, w1, a, c, f), K.fused_linear_act_plain(y_in, w1, a, c, f), 2e-2)
    fb = f.to(torch.bfloat16)
    codes, xmax = K.int8_lin1(fb, y_in, w1, a, c)
    want_codes, want_max = K.int8_lin1_plain(fb, y_in, w1, a, c)
    torch.cuda.synchronize()
    same = bool(torch.equal(codes, want_codes)) and bool(torch.equal(xmax, want_max))
    print(f"  int8_eps_fused_l12 lin1 pass at Ci = 2, f{tuple(fb.shape)} bf16: codes and max|h1| equal the plain "
          f"version's: {same}")
    assert same, "K5a's lin1 pass at Ci = 2 differs from its plain version"
    by_name["int8_eps_fused_l12"].setdefault("phase10", {})["lin1 pass Ci = 2 (codes equal)"] = 0.0
    w2 = rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5)
    w_q, w_scale = Q.quantize_weight(w2)
    s2 = (w_scale * a).contiguous()
    args = (fb, y_in, w1, a, c, w_q, s2, c)
    held("int8_eps_fused_l12", f"Ci = 2 f{tuple(fb.shape)} bf16", K.int8_eps_l12(*args), K.int8_eps_l12_plain(*args),
         2e-2)
    for label, (b, n, h, d) in (("DeiT-distilled", (TRAIN_BATCH, 198, 12, 64)),
                                ("ConViT-base", (TRAIN_BATCH, 197, 16, 48))):
        qkv = rnd(b, n, 3, h, d, lo=-2.0, hi=2.0).requires_grad_(True)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        held("flash_attention", f"{label} {(b, n, h, d)} fp32", K.flash_attention(q, k, v),
             K.flash_attention_plain(q, k, v), 1e-4)
        d_out = rnd(b, n, h, d)
        (got,) = torch.autograd.grad(K.flash_attention(q, k, v), qkv, d_out)
        (want,) = torch.autograd.grad(K.flash_attention_plain(q, k, v), qkv, d_out)
        held("flash_attention", f"{label} {(b, n, h, d)} fp32 backward (kernel forward, plain VJP)", got, want, 1e-4)
        print(f"    ms={cuda_ms(lambda: K.flash_attention(q, k, v), 20):.4f}")


def serve_behind_batcher(predict, label):
    """A MicroBatcher(max_batch=8) in front of ``predict``, three callers at
    once (1, 3 and 4 images): each gets its own rows of fewer device calls
    than requests."""
    from ladine_tpu_torch.infer.batching import MicroBatcher

    calls = []

    def fn(batch):
        result = predict(batch)
        calls.append((batch, result))
        return result

    batcher = MicroBatcher(fn, max_batch=8, max_wait_ms=200)
    rng = np.random.default_rng(5)
    requests = [rng.random((n, 224, 224, 3), dtype="float32") for n in (1, 3, 4)]
    results = [None] * len(requests)

    def caller(i):
        results[i] = batcher.predict(requests[i])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    batcher.close()
    stats = batcher.stats()
    print(f"  MicroBatcher(max_batch=8) in front of {label}: requests of 1, 3 and 4 images from three "
          f"threads in {dt * 1e3:.1f} ms; device calls of {[len(b) for b, _ in calls]} images; stats {stats}")
    for req, res in zip(requests, results):
        assert res is not None, "a caller got no answer"
        check_outputs(res, len(req))
        # its rows of the device call that carried its images
        hits = [(b, r, off) for b, r in calls for off in range(len(b) - len(req) + 1)
                if np.array_equal(b[off:off + len(req)], req)]
        assert len(hits) == 1, "a caller's images are not in exactly one device call"
        b, r, off = hits[0]
        assert all(np.array_equal(res[k], r[k][off:off + len(req)]) for k in res)
    assert stats["device_calls"] < len(requests) and stats["requests"] == len(requests), stats


def bit_equal(fresh, orig) -> int:
    """Asserts two modules hold the same tensors, bit for bit; their number."""
    a, b = fresh.state_dict(), orig.state_dict()
    assert sorted(a) == sorted(b)
    differ = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    assert not differ, f"tensors differ after the reference round trip: {differ[:5]}"
    return len(a)


def check_outputs(out, batch):
    probs = out["probs"]
    assert probs.shape == (batch, 2) and all(np.isfinite(v).all() for v in out.values()), out
    assert abs(probs.sum(-1) - 1.0).max() < 1e-4, probs
    assert ((out["majority_vote"] >= 0) & (out["majority_vote"] < 2)).all(), out


def stages(pred, images, label):
    """Host-clock time of the stages of one eager request, each ended by a
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
    total_ms = timed_ms(lambda: eager_request(pred, images, EAGER_SEED))
    print(f"  stages of one {label} request: guidance heads {heads_ms:.1f} ms, member encoders "
          f"{enc_ms:.1f} ms, reverse chain + aggregation {total_ms - heads_ms - enc_ms:.1f} ms, "
          f"total {total_ms:.1f} ms")


# Device time by source in the traces: (label, a substring of the kernel's name)
TRACE_SOURCES = (
    ("K1 fused_linear.cu", "fused_linear_"),
    ("K3 attention.cu", "attention_"),
    ("int8 quantizing pre-pass (K4, K5b)", "quantize_rows_kernel"),
    ("K5a lin1 pass", "lin1_quantize_kernel"),
    # the serving path's float32 rows (the features' dtype)
    ("int8 GEMM, STORE epilogue (K4, K5a)", "int8_gemm_kernel<float, 0>"),
    ("int8 GEMM, LIN4 epilogue (K5b)", "int8_gemm_kernel<float, 1>"),
)


def trace(request, label, top: int = 8):
    """Where a request's device time goes: torch.profiler over one call of
    ``request``, device time summed by kernel name, and the device's busy
    share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"  trace of one {label} request: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), idle {100 * (1 - busy_ms / wall_ms):.1f} %, "
          f"{sum(e.count for e in rows)} device launches")
    for src, tag in TRACE_SOURCES:
        hits = [e for e in rows if tag in e.key]
        if hits:
            ms, n = sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits)
            print(f"    {src}: {ms:.2f} ms in {n} launches ({ms / n:.4f} ms a launch)")
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


# Phase 11: the mesh at full width, two gloo ranks sharing the one card
MESH_DIR = "_smoke_mesh"  # the ranks' rendezvous file and report, beside this script (gitignored)
MESH_TIMEOUT_S = 120  # every collective of phase 11: a rank that dies cannot hang the script
MESH_SEED = 1111  # the generator of phase 11's requests and draws
# (a)'s requests: preset, flags, and each kernel's launches a request on a rank
MESH_REQUESTS = {
    "parity": ("parity", {}, {"fused_linear_act": 3000, "flash_attention": 5}),
    "serving + use_int8_pallas": ("serving", dict(use_int8_pallas=True),
                                  {"int8_linear_softplus": 100, "flash_attention": 5}),
    "serving + use_int8_pallas + pallas_fuse_ends": (
        "serving", dict(use_int8_pallas=True, pallas_fuse_ends=True),
        {"int8_eps_fused_l12": 50, "int8_eps_fused_l34": 50, "flash_attention": 5}),
}
MESH_EVAL = dict(mc_trials=20, ddim_steps=10, ddim_eta=1.0, use_int8=True, use_int8_encode=True, attack_name="PGD",
                 attack_eps=0.03)  # fast, with PGD
# (b)'s steps: the mesh's rows of ranks, lowmem, FSDP, the compute dtype
# (of the guidance and the members); bfloat16 is every deployment config's
MESH_TRAIN = {
    "(b1) 2 members on (member 2, data 1), bf16, fp32 Adam + EMA": ([[0], [1]], False, False, torch.bfloat16),
    "(b2) 2 members on (member 1, data 2), bf16, fsdp_plan + lowmem": ([[0, 1]], True, True, torch.bfloat16),
    "(b1) 2 members on (member 2, data 1), fp32, fp32 Adam + EMA": ([[0], [1]], False, False, torch.float32),
    "(b2) 2 members on (member 1, data 2), fp32, fsdp_plan + lowmem": ([[0, 1]], True, True, torch.float32),
}
MESH_HEADS = (0, 1)  # the guidance heads of (b)'s two members: ViT blocks 0-1, K3 twice a step
PROBE_COLS = 1 << 16  # columns of each member row of a leaf that (b) compares
# the biases before a train-mode BatchNorm: their exact gradient is zero,
# so their first moments are rounding noise on both sides (left out)
PRE_BN_BIASES = ("enc_lin1.bias", "enc_lin2.bias", "enc_lin3.bias")
# (b)'s bfloat16 bars against the float64 witness (hold_step)
BF16_LOSS_RTOL = 2.0**-8
BF16_MU_FACTOR = 2.0


def mesh_modules(dtype=torch.bfloat16):
    """Phase 4's guidance and five members in ``dtype``, from its seeded
    generator, and the schedule."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch.models import init_random_

    gen = torch.Generator(device="cuda").manual_seed(0)
    guidance = init_random_(L.SEViTGuidance(device="cuda", dtype=dtype), gen)
    model = init_random_(L.ConditionalModel(5, device="cuda", dtype=dtype), gen)
    sched = L.DiffusionSchedule.create("linear", 1000, 1e-4, 0.02, device="cuda")
    return guidance, model, sched


def mesh_guidance(dtype):
    """(b)'s guidance: phase 4's in ``dtype`` (its seeded generator, drawn first)."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch.models import init_random_

    gen = torch.Generator(device="cuda").manual_seed(0)
    return init_random_(L.SEViTGuidance(device="cuda", dtype=dtype), gen)


def mesh_inputs():
    """(a)'s and (c)'s images and labels, (b)'s batch and injected draws."""
    rng = np.random.default_rng(11)
    images = rng.random((BATCH, 224, 224, 3), dtype="float32")
    labels = rng.integers(0, 2, BATCH)
    train_images = torch.from_numpy(rng.random((TRAIN_BATCH, 224, 224, 3), dtype="float32"))
    train_labels = torch.from_numpy(rng.integers(0, 2, TRAIN_BATCH))
    t = torch.from_numpy(rng.integers(0, 1000, (2, TRAIN_BATCH)))
    noise = torch.from_numpy(rng.standard_normal((2, TRAIN_BATCH, 2)).astype(np.float32))
    return images, labels, train_images, train_labels, t, noise


def mesh_serve(guidance, model, sched, images, label, mesh=None):
    """(a): one request at ``label``'s operating point, its launches counted
    after the call that captures the batch's graph; (outputs, launches,
    ms of the replay)."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K

    preset, flags, _ = MESH_REQUESTS[label]
    pred = L.Predictor.from_preset(preset, guidance=guidance, model=model, sched=sched, mc_trials=20, mesh=mesh,
                                   **flags)
    pred.predict(images, generator=generator(MESH_SEED))  # warm-up and capture
    before = {k: K.launch_counts[k] for k in KERNELS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pred.predict(images, generator=generator(MESH_SEED))
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: K.launch_counts[k] - before[k] for k in KERNELS}, ms


def mesh_evaluate(guidance, model, sched, images, labels, mesh=None):
    """(c): one batch through ``evaluate_ensemble`` twice (the first
    captures the graph); the second's samples, launches and seconds."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.infer import EvalConfig, evaluate_ensemble, make_eval_pipeline

    cfg = EvalConfig(**MESH_EVAL)
    pipe = make_eval_pipeline(guidance, model, sched, cfg, mesh=mesh)
    run = lambda: evaluate_ensemble(guidance, model, sched, [(images, labels)], cfg,  # noqa: E731
                                    generator=torch.Generator().manual_seed(MESH_SEED), mesh=mesh, pipeline=pipe)
    run()
    before = {k: K.launch_counts[k] for k in KERNELS}
    t0 = time.perf_counter()
    report = run()
    return report["samples"], {k: K.launch_counts[k] - before[k] for k in KERNELS}, time.perf_counter() - t0


def mesh_train(guidance, sched, label, mesh=None, dtype=None):
    """(b): one full train step of two members from a fresh state (seeded),
    with injected draws, then a second step timed; the first step's losses,
    its parameters and first moments on each leaf's probe columns (rows and
    columns this rank holds), the leaves' largest |mu|, ms a step and peak
    GiB. ``dtype``: the members' compute dtype (the case's when None)."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.models import ConditionalModel
    from ladine_tpu_torch.parallel import fsdp_plan
    from ladine_tpu_torch.parallel.mesh import leaf_window
    from ladine_tpu_torch.train import create_member_states, make_full_train_step, make_optimizer

    _, lowmem, fsdp, case_dtype = MESH_TRAIN[label]
    W = FULL_WIDTHS
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    _, _, images, labels, t, noise = mesh_inputs()
    images, labels, t, noise = (v.cuda() for v in (images, labels, t, noise))
    compute = ConditionalModel(2, W["data_dim"], W["feature"], W["hidden"], 2, W["n_steps"], device="meta",
                               dtype=dtype or case_dtype)
    plan = fsdp_plan(compute.state_dict(), mesh) if fsdp and mesh is not None else frozenset()
    tx = make_optimizer("Adam", 1e-3, lowmem=lowmem)
    gen = generator(MESH_SEED)
    state = create_member_states(compute, gen, tx, 2, lowmem=lowmem, device="cuda", mesh=mesh, fsdp=plan)
    step = make_full_train_step(guidance, compute, tx, sched, 5, 2, head_indices=MESH_HEADS, mesh=mesh, fsdp=plan)
    n3 = K.launch_counts["flash_attention"]
    state, losses = step(state, images, labels, gen, t=t, noise=noise)
    torch.cuda.synchronize()
    k3 = K.launch_counts["flash_attention"] - n3
    probes = {}
    for part, tensors in (("params", state.params), ("mu", state.opt_state["mu"])):
        for k, v in tensors.items():
            view = v.view(v.shape[0], -1)
            w = leaf_window(view, mesh, k in plan)
            cols = torch.arange(0, w.cols, max(1, w.cols // PROBE_COLS))
            mine = (cols >= w.col0) & (cols < w.col0 + view.shape[1])
            probes[(part, k)] = (w.row0, cols[mine], view[:, (cols[mine] - w.col0).cuda()].float().cpu())
    mu_max = {k: float(v.float().abs().max()) for k, v in state.opt_state["mu"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, images, labels, gen, t=t, noise=noise)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"losses": losses.cpu().numpy(), "probes": probes, "mu_max": mu_max, "k3": k3, "ms": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "fsdp": sorted(plan)}


def mesh_reference():
    """Phase 11's one-process results, made before the ranks start: (a)'s
    requests, (c)'s samples, (b)'s steps and the float64 witness of each
    bfloat16 step (its members computed in float64 behind the same bfloat16
    guidance)."""
    guidance, model, sched = mesh_modules()
    images, labels = mesh_inputs()[:2]
    ref = {"serve": {}, "train": {}, "witness": {}}
    for label in MESH_REQUESTS:
        out, counts, ms = mesh_serve(guidance, model, sched, images, label)
        ref["serve"][label] = out
        print(f"  one process, {label}: {ms:.1f} ms (graph); launches {counts}")
    ref["eval"], counts, sec = mesh_evaluate(guidance, model, sched, images, labels)
    print(f"  one process, evaluate_ensemble at fast + PGD: {sec:.2f} s; launches {counts}")
    del model
    for dtype in (torch.bfloat16, torch.float32):
        if dtype != torch.bfloat16:
            del guidance
            free_memory()
            guidance = mesh_guidance(dtype)
        for label in mesh_cases(dtype):
            ref["train"][label] = r = mesh_train(guidance, sched, label)
            print(f"  one process, {label}: losses {r['losses'].tolist()}, {r['ms']:.1f} ms a step, peak "
                  f"{r['peak_gib']:.2f} GiB")
            if dtype == torch.bfloat16:
                ref["witness"][label] = w = mesh_train(guidance, sched, label, dtype=torch.float64)
                print(f"  float64 witness of {label}: losses {w['losses'].tolist()}, peak {w['peak_gib']:.2f} GiB")
    del guidance
    free_memory()
    return ref


def mesh_cases(dtype):
    """(b)'s cases of one compute dtype."""
    return [label for label, spec in MESH_TRAIN.items() if spec[3] == dtype]


def mesh_rank(ref_path: str, out_path: str) -> None:
    """One rank of phase 11: (a), (c), (b) on their meshes against the
    one-process results in ``ref_path``; its counts, times and errors go to
    rank 0, which writes them all to ``out_path``. Any failed bar raises."""
    import torch.distributed as dist

    from ladine_tpu_torch.parallel.mesh import mesh_of

    torch.cuda.set_device(0)
    rank = dist.get_rank()
    ref = torch.load(ref_path, weights_only=False)
    report = {"rank": rank, "serve": {}, "train": {}}
    t0 = time.perf_counter()
    guidance, model, sched = mesh_modules()
    images, labels = mesh_inputs()[:2]
    mesh = mesh_of([[0, 1]], "cuda")
    report["seconds"] = {"modules": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for label, (_, _, want) in MESH_REQUESTS.items():
        out, counts, ms = mesh_serve(guidance, model, sched, images, label, mesh)
        check_outputs(out, BATCH)
        base = ref["serve"][label]
        diff = {k: float(np.abs(out[k] - base[k]).max()) for k in ("probs", "piw", "mc_variance")}
        exact = all(np.array_equal(out[k], base[k]) for k in OUTPUTS)
        assert np.array_equal(out["majority_vote"], base["majority_vote"]), label
        for k in diff:
            np.testing.assert_allclose(out[k], base[k], rtol=1e-4, atol=1e-5, err_msg=f"{label} {k}")
        assert counts == {k: want.get(k, 0) for k in KERNELS}, (label, counts)
        report["serve"][label] = {"ms": ms, "launches": counts, "max_diff": diff, "bit_equal": exact}
        print(f"  rank {rank}: (a) {label} held; {gib_now()}", flush=True)
    report["seconds"]["(a)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples, counts, sec = mesh_evaluate(guidance, model, sched, images, labels, mesh)
    np.testing.assert_allclose(samples, ref["eval"], rtol=1e-4, atol=1e-5, err_msg="evaluate_ensemble samples")
    want = {k: 0 for k in KERNELS}
    want["flash_attention"] = PGD_FORWARDS * VIT_DEPTH + 5
    assert counts == want, ("evaluate_ensemble", counts)
    report["eval"] = {"seconds": sec, "launches": counts, "max_diff": float(np.abs(samples - ref["eval"]).max()),
                      "bit_equal": bool(np.array_equal(samples, ref["eval"]))}
    report["seconds"]["(c)"] = time.perf_counter() - t0
    print(f"  rank {rank}: (c) held; {gib_now()}", flush=True)
    del model
    free_memory()
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        if dtype != torch.bfloat16:
            del guidance
            free_memory()
            guidance = mesh_guidance(dtype)
        for label in mesh_cases(dtype):
            got = mesh_train(guidance, sched, label, mesh_of(MESH_TRAIN[label][0], "cuda"))
            report["train"][label] = hold_step(label, got, ref["train"][label], ref["witness"].get(label))
            print(f"  rank {rank}: {label} held; peak {got['peak_gib']:.2f} GiB", flush=True)
    del guidance
    report["seconds"]["(b)"] = time.perf_counter() - t0
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, report)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(reports, f)


def probe_at(result, part, k, row0, cols, rows):
    """``result``'s (one process) probe values of leaf ``k`` at a rank's
    ``rows`` from ``row0`` and its probe columns ``cols``."""
    _, all_cols, vals = result["probes"][(part, k)]
    return vals[row0:row0 + rows][:, torch.isin(all_cols, cols)]


def hold_step(label, got, base, witness=None):
    """(b)'s bars on a rank: its step ``got`` against the one-process step
    ``base`` on the rank's probes. A float32 case: losses rtol 1e-5,
    parameters atol 2.1e-3, first moments 1e-3 of their leaf's largest (a
    bfloat16 moment of ``lowmem`` may also round one step apart). A
    bfloat16 case holds both steps against the float64 ``witness``: each
    within BF16_LOSS_RTOL of its losses, and the rank's first moments no
    farther from its moments than BF16_MU_FACTOR times the one-process
    step's own distance, leaf by leaf, floored at one bfloat16 unit of the
    leaf's largest. Returns the report entry."""
    lowmem = MESH_TRAIN[label][1]
    rel = lambda a, b: float(np.abs(a / b - 1).max())  # noqa: E731
    entry = {"ms": got["ms"], "peak_gib": got["peak_gib"], "k3": got["k3"], "fsdp_leaves": len(got["fsdp"]),
             "loss_rel": rel(got["losses"], base["losses"]), "params_abs": 0.0, "mu_of_max": 0.0}
    assert got["k3"] == len(MESH_HEADS), (label, got["k3"])
    if witness is None:
        np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-5, err_msg=f"{label} losses")
    else:
        entry["loss_rel_f64"] = [rel(base["losses"], witness["losses"]), rel(got["losses"], witness["losses"])]
        assert max(entry["loss_rel_f64"]) <= BF16_LOSS_RTOL, (label, entry["loss_rel_f64"])
        entry["mu_f64"] = {}
    for (part, k), (row0, cols, vals) in got["probes"].items():
        if part == "mu" and k in PRE_BN_BIASES:
            continue
        want = probe_at(base, part, k, row0, cols, vals.shape[0])
        diff = (vals - want).abs()
        if part == "params":
            assert (diff <= 2.1e-3).all(), (label, part, k, float(diff.max()))
            entry["params_abs"] = max(entry["params_abs"], float(diff.max()))
            continue
        # a bfloat16 moment (lowmem) may round a step apart
        step = 2.0**-7 * want.abs() if lowmem else 0.0
        entry["mu_of_max"] = max(entry["mu_of_max"], float(diff.max()) / max(base["mu_max"][k], 1e-30))
        if witness is None:
            assert (diff <= 1e-3 * base["mu_max"][k] + step).all(), (label, part, k, float(diff.max()))
            continue
        exact = probe_at(witness, part, k, row0, cols, vals.shape[0])
        top = max(witness["mu_max"][k], 1e-30)
        own = float(((want - exact).abs() - step).clamp_min(0).max()) / top
        mine = float(((vals - exact).abs() - step).clamp_min(0).max()) / top
        entry["mu_f64"][k] = (own, mine)
        assert mine <= BF16_MU_FACTOR * max(own, 2.0**-8), (label, k, own, mine)
    return entry


def _mesh_entry(rank: int, world: int, root: str) -> None:
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'rdzv')}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh_rank(os.path.join(root, "reference.pt"), os.path.join(root, "report.json"))
    finally:
        dist.destroy_process_group()


def run_mesh():
    """Phase 11 (a)-(c): the one-process references here, then two ranks
    spawned on the card (a rank's exception is raised here by
    ``torch.multiprocessing.spawn``, after which the script fails). Returns
    each kernel's launches on a rank over (a)."""
    import torch.multiprocessing as mp

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), MESH_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        torch.save(mesh_reference(), os.path.join(root, "reference.pt"))
        ref_s = time.perf_counter() - t0
        print(f"  one-process references in {ref_s:.1f} s; {gib_now()}; spawning 2 ranks over gloo on the card")
        t0 = time.perf_counter()
        mp.spawn(_mesh_entry, args=(2, root), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        with open(os.path.join(root, "report.json")) as f:
            reports = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = gpu_line()
    for r in reports:
        print(f"  rank {r['rank']} (two processes sharing one {card}: not a multi-card time):")
        for label, a in r["serve"].items():
            print(f"    (a) {label}: {a['ms']:.1f} ms a request (graph, 4 of the batch's 8 images); launches "
                  f"{a['launches']}; max |difference| from one process {a['max_diff']}; bit-equal {a['bit_equal']}")
        e = r["eval"]
        print(f"    (c) evaluate_ensemble, fast + PGD, batch 8: {e['seconds']:.2f} s; launches {e['launches']}; "
              f"samples max |difference| {e['max_diff']:.2e}; bit-equal {e['bit_equal']}")
        for label, b in r["train"].items():
            print(f"    {label}: {b['ms']:.1f} ms a step, peak {b['peak_gib']:.2f} GiB, K3 {b['k3']} a step; "
                  f"losses rel {b['loss_rel']:.2e}, params max |difference| {b['params_abs']:.2e}, first moments "
                  f"{b['mu_of_max']:.2e} of their leaf's largest; {b['fsdp_leaves']} leaves sharded over data")
            if "loss_rel_f64" in b:
                own, mine = b["loss_rel_f64"]
                ratio = max(m / max(o, 2.0**-8) for o, m in b["mu_f64"].values())
                print(f"      against the float64 witness: losses rel {own:.2e} (one process) and {mine:.2e} "
                      f"(this rank); first moments, each leaf's largest error over its largest moment, at most "
                      f"{max(o for o, _ in b['mu_f64'].values()):.2e} (one process) and "
                      f"{max(m for _, m in b['mu_f64'].values()):.2e} (this rank), the rank's at most {ratio:.2f} "
                      f"times the one process's (floored at 2^-8)")
        print(f"    seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items()))
    print(f"  phase 11 seconds: references {ref_s:.1f}, the two ranks {spawn_s:.1f}")
    launches = {k: 0 for k in KERNELS}
    for a in reports[0]["serve"].values():
        for k, v in a["launches"].items():
            launches[k] += v
    return launches


def check_phase11_shapes(entries):
    """After phase 11 (not counted): each kernel against its plain version
    at the shapes a rank gave it: 80 rows a member (4 images x 20 trials)
    in K1 (lin2/lin3 and lin1 at K = 4), K4, K5a and K5b; K3 at the
    guidance's 197 tokens, bf16 at batches 4, 15 and 30 and fp32 at 15 and
    30. Each entry's
    ``max_abs_err`` takes the largest error, and ``phase11`` lists them."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(11)
    by_name = {e["name"]: e for e in entries}

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    def held(name, label, got, want, tol):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(compare(f"{name} {label}", a, b, tol) for a, b in zip(got, want))
        by_name[name].setdefault("phase11", {})[label] = err
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    bf16 = torch.bfloat16
    m, r, f_ = 5, 20 * BATCH // 2, FULL_WIDTHS["feature"]
    x = rnd(m, r, f_, lo=0.0, hi=2.0, dtype=bf16)
    w = rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5, dtype=bf16)
    a, c = rnd(m, f_, lo=0.5, hi=1.5), rnd(m, f_, lo=-0.5, hi=0.5)
    held("fused_linear_act", f"lin2/lin3 {tuple(x.shape)} bf16", K.fused_linear_act(x, w, a, c, None),
         K.fused_linear_act_plain(x, w, a, c, None), 2e-2)
    f = rnd(m, r, f_)
    y_in = rnd(m, r, 4, lo=0.0, hi=1.0, dtype=bf16)
    w1 = rnd(m, 4, f_, lo=-0.5, hi=0.5, dtype=bf16)
    held("fused_linear_act", f"lin1 K = 4 y_in{tuple(y_in.shape)} bf16, gate fp32",
         K.fused_linear_act(y_in, w1, a, c, f), K.fused_linear_act_plain(y_in, w1, a, c, f), 2e-2)
    # the guidance's 197 tokens at (a)'s and (c)'s batch 4 a rank, (b1)'s
    # whole 30 and (b2)'s 15 a rank, in (b)'s two compute dtypes
    for dtype, batches, tol in ((bf16, (BATCH // 2, TRAIN_BATCH // 2, TRAIN_BATCH), 2e-2),
                                (torch.float32, (TRAIN_BATCH // 2, TRAIN_BATCH), 1e-4)):
        for b in batches:
            qkv = rnd(b, 197, 3, 12, 64, lo=-2.0, hi=2.0, dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            held("flash_attention", f"{(b, 197, 12, 64)} {str(dtype)[6:]}", K.flash_attention(q, k, v),
                 K.flash_attention_plain(q, k, v), tol)
    w_q, w_scale = Q.quantize_weight(w.float())
    s = (w_scale * a).contiguous()
    h = rnd(m, r, f_, lo=0.0, hi=2.0)
    xmax = h.amax(-1, keepdim=True).contiguous()
    colsum = w_q.sum(dim=1, dtype=torch.int32).float()
    args = (h, xmax, w_q, s, c, colsum)
    held("int8_linear_softplus", f"zero-point {tuple(h.shape)} fp32", K.int8_linear_softplus(*args),
         K.int8_linear_softplus_plain(*args), 1e-3)
    fb, yb = f.to(bf16), y_in
    args = (fb, yb, w1, a, c, w_q, s, c)
    held("int8_eps_fused_l12", f"f{tuple(fb.shape)} bf16", K.int8_eps_l12(*args), K.int8_eps_l12_plain(*args), 2e-2)
    w4 = rnd(m, f_, 2, lo=-f_**-0.5, hi=f_**-0.5)  # h2's dtype: the float32 rows
    args = (h, xmax, w_q, s, c, colsum, w4)
    held("int8_eps_fused_l34", f"h2{tuple(h.shape)} fp32, w4{tuple(w4.shape)}", K.int8_eps_l34(*args),
         K.int8_eps_l34_plain(*args), 1e-3)


# Phase 12: the 10-class real-data path at configs/digits.yml's widths (32
# px, patch 8, embed 48 over 4 heads of D = 12, depth 5, feature = hidden =
# 64, T = 100, 5 members, 10 classes, MC 10) on the committed digits corpus,
# its epochs cut (depth), never its widths
DIGITS_DIR = "_smoke_digits"  # beside this script (gitignored), deleted at the end
DIGITS_EPOCHS = (6, 10)  # stage 1 and stage 3, cut from the evidence run's 40 and 40
DIGITS_MV_BAR = 40.0  # the clean test's majority-vote accuracy must reach this, % (PERF.md §2)
DIGITS_INT8_POINTS = 3.0  # each int8 row's majority-vote accuracy within this of the float row's
DIGITS_CLASSES, DIGITS_DEPTH, DIGITS_HEADS, DIGITS_FEATURE = 10, 5, 4, 64
DIGITS_N = {"train": 1298, "valid": 144, "test": 355}  # 1442 train images carved 90/10, and t10k
DIGITS_DDIM, DIGITS_VAL_DDIM, DIGITS_MC = 25, 10, 10  # --ddim 25; the config's val_ddim_steps, mc_trials
DIGITS_VALIDATION_FREQ = 5  # the config's training.validation_freq
DIGITS_INT8_SUITE = {  # test rows on the 355 images: EvalConfig overrides, chain launches a graph unit
    "serving": ({"use_int8": True}, {}),
    "use_int8_pallas": ({"use_int8": True, "use_int8_pallas": True}, {"int8_linear_softplus": 2 * DIGITS_DDIM}),
    "pallas_fuse_ends": ({"use_int8": True, "use_int8_pallas": True, "pallas_fuse_ends": True},
                         {"int8_eps_fused_l12": DIGITS_DDIM, "int8_eps_fused_l34": DIGITS_DDIM}),
}


def graph_units(n: int, batch: int) -> int:
    """How many times an evaluation over ``n`` images at ``batch`` counts
    its per-batch launches: each batch shape's first batch twice (the
    graph's eager warm-up, then its replay), every later batch once."""
    full, tail = divmod(n, batch)
    return (full + 1 if full else 0) + (2 if tail else 0)


def digits_step_launches(module: str, argv: list, e1: int, e3: int) -> dict:
    """Each kernel's launches in one step of ``run_digits`` at epochs
    (``e1``, ``e3``). K3 runs once a ViT block of a forward (its VJP is not
    a launch); K1 three times an eps call."""
    def ceil(n, b):
        return -(-n // b)

    def value(flag):
        return argv[argv.index(flag) + 1]

    name = module.rsplit(".", 1)[1]
    train_steps = ceil(DIGITS_N["train"], 32)
    if name == "train_transformer":  # every epoch: the train steps, then the valid split at batch 70
        return {"flash_attention": DIGITS_DEPTH * (train_steps + ceil(DIGITS_N["valid"], 70)) * e1}
    if name == "train_mapping":  # MLP k taps after block k + 1: train steps and the valid split at 32
        blocks = int(value("--mlp_idx")) + 1
        return {"flash_attention": blocks * (train_steps + ceil(DIGITS_N["valid"], 32)) * e1}
    if "--train" in argv:
        # validations at the config's frequency and the last epoch: DDIM-10,
        # one trial, the valid split at the sampling batch 64
        validations = sum(1 for e in range(e3) if e % DIGITS_VALIDATION_FREQ == 0 or e + 1 == e3)
        want = {"fused_linear_act": 3 * DIGITS_VAL_DDIM * ceil(DIGITS_N["valid"], 64) * validations}
        if value("--mlp_idx") == "0":  # member 0 precomputes every head's y0_hat; the others read its cache
            want["flash_attention"] = DIGITS_DEPTH * (train_steps + ceil(DIGITS_N["valid"], 64))
        return want
    units = graph_units(DIGITS_N["valid" if "--calib" in argv else "test"], 64)
    want = {"fused_linear_act": 3 * DIGITS_DDIM * units, "flash_attention": DIGITS_DEPTH * units}
    if "--attack_name" in argv:  # FGSM: a gradient forward and a success forward of the ViT a batch
        want["flash_attention"] += 2 * DIGITS_DEPTH * ceil(DIGITS_N["test"], 64)
    return want


def run_digits_pipeline(root: str):
    """Phase 12 (a): ``examples/run_digits.py`` on the committed corpus at
    ``DIGITS_EPOCHS``, each step's launches held to
    :func:`digits_step_launches`; then (b) the int8 test rows of
    ``DIGITS_INT8_SUITE`` through ``cli.main --test --suite`` on the same
    members. Returns (each kernel's launches, the summary, the members'
    checkpoints, the calibrated temperature)."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.cli import main as cli_main
    from ladine_tpu_torch.examples import run_digits

    e1, e3 = DIGITS_EPOCHS
    total = dict.fromkeys(KERNELS, 0)
    ckpts = []

    def counted(module, argv, log_path, done=None):
        before = {k: K.launch_counts[k] for k in KERNELS}
        vjp = K.vjp_runs["flash_attention"]
        seconds = run_digits.run_step(module, argv, log_path, done)
        got = {k: K.launch_counts[k] - before[k] for k in KERNELS if K.launch_counts[k] != before[k]}
        want = {k: v for k, v in digits_step_launches(module, argv, e1, e3).items() if v}
        doc = argv[argv.index("--doc") + 1] if "--doc" in argv else module.rsplit(".", 1)[1]
        print(f"    {doc}{' ' + argv[argv.index('--mlp_idx') + 1] if doc == 'train_mapping' else ''}: "
              f"{seconds:.1f} s, launches {got}, K3 VJP runs {K.vjp_runs['flash_attention'] - vjp}")
        assert got == want, (module, argv, got, want)
        for k, v in got.items():
            total[k] += v
        return seconds

    work = os.path.join(root, "run")
    t0 = time.perf_counter()
    out = run_digits.run(work, "cuda", epochs=DIGITS_EPOCHS, step=counted)
    print(f"  (a) run_digits at epochs {DIGITS_EPOCHS} in {time.perf_counter() - t0:.1f} s: ViT val acc "
          f"{out['stage1a_vit_val_acc']:.2f} %, MLPs {out['stage1b_mlp_val_accs']}, T {out['calibrated_temperature']:.4g} "
          f"(vote-fraction ECE limit {out['ece_vote_fraction_limit']:.4f}), EMA T {out['calibrated_temperature_ema']:.4g}")
    for key in ("test", "test_ema_debiased", "test_fgsm_eps0.03", "test_noise_0.1"):
        r = out[key]
        print(f"    {key}: mv-acc {r['majority_vote_accuracy']:.2f} ± {r['majority_vote_accuracy_ci95_pp']:.1f} %, "
              f"acc {r['mean_confidence_accuracy']:.2f} %, ECE {r['ece']:.4f}, NLL {r['nll']:.4f}, "
              f"Brier {r['brier']:.4f}, {r['num_instances']} images")
        assert r["num_instances"] == DIGITS_N["test"] and all(np.isfinite(v) for v in r.values()), (key, r)
    clean = out["test"]["majority_vote_accuracy"]
    print(f"    clean mv-acc {clean:.2f} % against the bar {DIGITS_MV_BAR} %: {'ok' if clean >= DIGITS_MV_BAR else 'FAIL'}")
    assert clean >= DIGITS_MV_BAR, f"the clean test's majority-vote accuracy {clean:.2f} % is under {DIGITS_MV_BAR} %"

    exp = os.path.join(work, "exp")
    for k in range(5):
        found = [p for p in os.listdir(os.path.join(exp, "logs", f"member{k}")) if "_ckpt_best_" in p]
        ckpts.append(os.path.join(exp, "logs", f"member{k}",
                                  max(found, key=lambda p: int(p.split("_eph")[1].split("_")[0]))))
    suite_path = os.path.join(root, "int8_suite.json")
    with open(suite_path, "w") as f:
        json.dump({name: o for name, (o, _) in DIGITS_INT8_SUITE.items()}, f)
    units = graph_units(DIGITS_N["test"], 64)
    want = dict.fromkeys(KERNELS, 0)
    for _, chain in DIGITS_INT8_SUITE.values():
        want["flash_attention"] += DIGITS_DEPTH * units
        for k, v in chain.items():
            want[k] += v * units
    temperature = out["calibrated_temperature"]
    res, c = run_cli("(b) main --test --suite (serving, + use_int8_pallas, + pallas_fuse_ends)", cli_main.main,
                     ["--device", "cuda", "--config", run_digits.CONFIG, "--dataroot", os.path.join(work, "digits_root"),
                      "--exp", exp, "--doc", "int8_suite", "--test", "--suite", suite_path, "--ddim", str(DIGITS_DDIM),
                      "--eta", "1.0", "--temperature", str(temperature), "--diffusion_ckpt", *ckpts],
                     want, root, train_images=False)
    for name, row in res["rows"].items():
        gap = row["mv_accuracy"] - clean
        print(f"    int8 row {name}: mv-acc {row['mv_accuracy']:.2f} % ({gap:+.2f} points from the float row), "
              f"acc {row['accuracy']:.2f} %, ECE {row['ece']:.4f}")
        assert abs(gap) <= DIGITS_INT8_POINTS, (name, row, clean)
    for k, v in c.items():
        total[k] += v
    return total, out, ckpts, temperature


def digits_bf16(root: str, ckpts, temperature):
    """Phase 12 (c), the bf16 path that F6 and F7 open: a bf16
    ``Predictor`` from (a)'s checkpoints (lin1 at K = 20 with the float32
    gate, K3 at D = 12), eager against graphed at DDIM-25 and at
    ``serving`` + K5 (equal exactly; K5 within K5_RTOL); a bf16 ViT forward
    of the stage-1 checkpoint against its float32 forward; one bf16 member
    train step at 10 classes. Returns each kernel's launches."""
    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.cli.runner import Runner
    from ladine_tpu_torch.config import Config
    from ladine_tpu_torch.data.downloads import load_mnist_family
    from ladine_tpu_torch.examples import run_digits
    from ladine_tpu_torch.models import ConditionalModel, ViT
    from ladine_tpu_torch.train import create_member_states, make_member_step, make_optimizer
    from ladine_tpu_torch.utils import load_checkpoint

    before = {k: K.launch_counts[k] for k in KERNELS}
    cfg = Config.from_yaml(run_digits.CONFIG)
    cfg.model.dtype = "bfloat16"
    runner = Runner(cfg, log_dir=None, device="cuda")
    stacked, g_tree, heads = runner.load_members_from_train_ckpts(ckpts, eval_cast=True)
    gvars = {"params": runner.to_eval_vars(g_tree["params"], runner.guidance, eval_cast=True)}
    guidance, model = runner.guidance_module(gvars), runner.members_module(stacked)
    assert next(model.parameters()).dtype == torch.bfloat16 and model.lin1.linear.weight.shape[-2] == 20
    data_root = os.path.join(root, "run", "digits_root")
    test = load_mnist_family("MNIST", data_root, "test", image_size=(32, 32))
    images, labels = next(test.batches(64))
    images = np.ascontiguousarray(images, dtype=np.float32)
    for name, flags, rtol, want in (
            ("bf16 DDIM-25", {}, 0.0, {"fused_linear_act": 3 * DIGITS_DDIM, "flash_attention": DIGITS_DEPTH}),
            ("bf16 serving + pallas_fuse_ends", dict(use_int8=True, use_int8_pallas=True, pallas_fuse_ends=True),
             K5_RTOL, {"int8_eps_fused_l12": DIGITS_DDIM, "int8_eps_fused_l34": DIGITS_DDIM,
                       "flash_attention": DIGITS_DEPTH})):
        pred = L.Predictor(guidance=guidance, model=model, sched=runner.sched, temperature=temperature,
                           mc_trials=DIGITS_MC, ddim_steps=DIGITS_DDIM, ddim_eta=1.0, head_indices=heads,
                           device="cuda", **flags)
        counts0 = {k: K.launch_counts[k] for k in KERNELS}
        eager = eager_request(pred, images, EAGER_SEED)
        eager_counts = {k: K.launch_counts[k] - counts0[k] for k in KERNELS if K.launch_counts[k] != counts0[k]}
        pred.predict(images, generator=generator(EAGER_SEED))  # warm-up and capture, then a replay
        counts0 = {k: K.launch_counts[k] for k in KERNELS}
        t0 = time.perf_counter()
        graphed = pred.predict(images, generator=generator(EAGER_SEED))
        graph_ms = (time.perf_counter() - t0) * 1e3
        graph_counts = {k: K.launch_counts[k] - counts0[k] for k in KERNELS if K.launch_counts[k] != counts0[k]}
        equal = same_outputs(graphed, eager, rtol)
        bits = same_outputs(graphed, eager, 0.0)
        acc = 100.0 * float((graphed["majority_vote"] == labels).mean())
        print(f"  (c) {name} Predictor, batch {len(images)}: graph {graph_ms:.1f} ms; graph against eager "
              f"{'equal' if equal else 'DIFFER'}{f' (rtol {rtol:g}; bit for bit: {bits})' if rtol else ' (exactly)'}; "
              f"mv-acc on the batch {acc:.1f} %; launches eager {eager_counts}, graph {graph_counts}")
        assert equal, (name, spread(graphed, eager))
        assert graphed["probs"].shape == (len(images), DIGITS_CLASSES) and np.isfinite(graphed["probs"]).all()
        assert eager_counts == want and graph_counts == want, (name, eager_counts, graph_counts, want)
        del pred
    # a bf16 ViT forward at D = 12 against the float32 forward of the same weights
    tree, _ = load_checkpoint(os.path.join(root, "run", "models", "vit_MNIST"))
    vits = {}
    for dtype in (torch.float32, torch.bfloat16):
        vit = ViT(DIGITS_CLASSES, 32, 8, 48, DIGITS_DEPTH, DIGITS_HEADS, device="cuda", dtype=dtype)
        vit.load_state_dict({k: v.to(dtype) for k, v in tree["params"].items()})
        vits[dtype] = vit
    x = torch.as_tensor(images, device="cuda")
    counts0 = K.launch_counts["flash_attention"]
    with torch.inference_mode():
        ref, got = vits[torch.float32](x), vits[torch.bfloat16](x.to(torch.bfloat16)).float()
    assert K.launch_counts["flash_attention"] - counts0 == 2 * DIGITS_DEPTH
    agree = float((ref.argmax(-1) == got.argmax(-1)).float().mean())
    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"  (c) bf16 ViT forward at D = 12, batch {len(x)}: logits within {err:.2e} of the float32 forward's "
          f"largest, argmax equal on {100 * agree:.1f} % of the images")
    assert torch.isfinite(got).all() and err < 5e-2 and agree >= 0.9, (err, agree)
    # one bf16 member step at 10 classes: y0 one-hot, y0_hat from the bf16 guidance (K3 at D = 12)
    compute = ConditionalModel(1, 3072, DIGITS_FEATURE, DIGITS_FEATURE, DIGITS_CLASSES, cfg.diffusion.timesteps + 1,
                               device="meta", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tx = make_optimizer("Adam", 1e-3)
    state = create_member_states(compute, gen, tx, 1, device="cuda")
    params0 = {k: v.clone() for k, v in state.params.items()}
    step = make_member_step(compute, tx, runner.sched)
    with torch.inference_mode():
        yh = torch.softmax(guidance.heads_subset(x.to(torch.bfloat16), (0,)).float(), -1)[0]
    y0 = torch.eye(DIGITS_CLASSES, device="cuda")[torch.as_tensor(labels, device="cuda")]
    state, loss = step(state, x.reshape(len(x), -1), y0, yh, gen)
    moved = sum(int(not torch.equal(state.params[k], params0[k])) for k in params0)
    print(f"  (c) bf16 member step at 10 classes, batch {len(x)}: loss {float(loss.float().mean()):.4f}, "
          f"{moved} of {len(params0)} leaves moved")
    assert torch.isfinite(loss).all() and moved == len(params0), (loss, moved)
    return {k: K.launch_counts[k] - before[k] for k in KERNELS}


def run_digits_phase():
    """Phase 12: (a) and (b) (:func:`run_digits_pipeline`), then (c)
    (:func:`digits_bf16`), in ``DIGITS_DIR`` beside this script (deleted at
    the end). Returns each kernel's launches over the phase."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, DIGITS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        launches, _, ckpts, temperature = run_digits_pipeline(root)
        t0 = time.perf_counter()
        bf16_launches = digits_bf16(root, ckpts, temperature)
        print(f"  (c) in {time.perf_counter() - t0:.1f} s; launches {bf16_launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {k: launches[k] + bf16_launches[k] for k in KERNELS}


def check_phase12_shapes(entries):
    """After phase 12 (not counted): each kernel against its plain version
    at the digits serving shapes (64 images x 10 trials = 640 rows a
    member, 5 members, 10 classes) at phase 2's tolerances, with its time,
    the plain version's, the bound and, for K3, the library call's: K1 lin1
    (5, 640, 20) -> 64 in float32 and in bf16 with the float32 gate (F6),
    lin2/lin3 (5, 640, 64) -> 64 in both; K3 at (64, 16|17, 4, 12) in both
    (F7 pads bf16 to D = 16) with its VJP; K4 at K = N = 64, K5a at Ci = 20
    and K5b at C = 10 on float32 rows. ``phase12`` lists each record."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(12)
    by_name = {e["name"]: e for e in entries}
    bf16, f32 = torch.bfloat16, torch.float32
    m, r, f_, c_ = 5, 64 * DIGITS_MC, DIGITS_FEATURE, DIGITS_CLASSES
    rate = {bf16: BF16_FLOP_PER_S, f32: FP32_FLOP_PER_S}

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=f32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    def held(name, label, fn, plain, inputs, work, tol, library=None):
        got, want = fn(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(compare(f"{name} {label}", a, b, tol) for a, b in zip(got, want))
        rec = dict(max_abs_err=err, ms=cuda_ms(fn, 50), plain_ms=cuda_ms(plain, 20), library_ms=None)
        rec["bound_ms"], rec["bound_by"] = bound((*inputs, *got), *work)
        if library is not None:
            rec["library_ms"] = cuda_ms(library, 20, spin=8_000_000)
        print(f"    ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})" + ("" if library is None else f" library_ms={rec['library_ms']:.4f}"))
        by_name[name].setdefault("phase12", {})[label] = rec
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    feats = rnd(m, r, f_)
    a, c = rnd(m, f_, lo=0.5, hi=1.5), rnd(m, f_, lo=-0.5, hi=0.5)
    for dtype, tol in ((f32, 1e-4), (bf16, 2e-2)):
        y_in = rnd(m, r, 2 * c_, lo=0.0, hi=1.0, dtype=dtype)
        w1 = rnd(m, 2 * c_, f_, lo=-0.5, hi=0.5, dtype=dtype)
        args = (y_in, w1, a, c, feats)
        held("fused_linear_act", f"lin1 K = 20 y_in{tuple(y_in.shape)} {str(dtype)[6:]}, gate fp32",
             lambda: K.fused_linear_act(*args), lambda: K.fused_linear_act_plain(*args), args,
             [(2 * m * r * 2 * c_ * f_, rate[dtype])], tol)
        h = rnd(m, r, f_, lo=0.0, hi=2.0, dtype=dtype)
        w = rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5, dtype=dtype)
        args2 = (h, w, a, c, None)
        held("fused_linear_act", f"lin2/lin3 {tuple(h.shape)}x{tuple(w.shape)} {str(dtype)[6:]}",
             lambda: K.fused_linear_act(*args2), lambda: K.fused_linear_act_plain(*args2), args2[:4],
             [(2 * m * r * f_ * f_, rate[dtype])], tol)
    b, h_, d = 64, DIGITS_HEADS, 48 // DIGITS_HEADS
    for n in (16, 17):  # the taps' bare patches; the classifier's patches and cls token
        for dtype, tol in ((f32, 1e-4), (bf16, 2e-2)):
            qkv = rnd(b, n, 3, h_, d, lo=-2.0, hi=2.0, dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            label = f"{(b, n, h_, d)} {str(dtype)[6:]}"
            held("flash_attention", label, lambda: K.flash_attention(q, k, v), lambda: K.flash_attention_plain(q, k, v),
                 (q, k, v), [(4 * b * h_ * n * n * d, rate[dtype])], tol,
                 library=lambda: F.scaled_dot_product_attention(qt, kt, vt))
            d_out, o = rnd(b, n, h_, d, dtype=dtype), K.flash_attention(q, k, v)
            qg = qkv.detach().requires_grad_(True)
            qs = (qg[:, :, 0], qg[:, :, 1], qg[:, :, 2])
            ql = tuple(t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
            held("flash_attention", f"{label} backward (kernel forward, plain VJP)",
                 lambda: torch.autograd.grad(K.flash_attention(*qs), qg, d_out),
                 lambda: torch.autograd.grad(K.flash_attention_plain(*qs), qg, d_out),
                 (q, k, v, o, d_out), [(10 * b * h_ * n * n * d, rate[dtype])], tol,
                 library=lambda: torch.autograd.grad(F.scaled_dot_product_attention(*ql), ql, d_out.transpose(1, 2)))
    w_q, w_scale = Q.quantize_weight(rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5))
    s = (w_scale * a).contiguous()
    colsum = w_q.sum(dim=1, dtype=torch.int32).float()
    x = rnd(m, r, f_, lo=0.0, hi=2.0)
    xmax = x.amax(-1, keepdim=True).contiguous()
    args = (x, xmax, w_q, s, c, colsum)
    held("int8_linear_softplus", f"zero-point x{tuple(x.shape)} fp32, w{tuple(w_q.shape)}",
         lambda: K.int8_linear_softplus(*args), lambda: K.int8_linear_softplus_plain(*args), args,
         [(2 * m * r * f_ * f_, INT8_OP_PER_S)], 1e-3)
    y_in = rnd(m, r, 2 * c_, lo=0.0, hi=1.0)
    w1 = rnd(m, 2 * c_, f_, lo=-0.5, hi=0.5)
    codes, hmax1 = K.int8_lin1(feats, y_in, w1, a, c)
    want_codes, want_max = K.int8_lin1_plain(feats, y_in, w1, a, c)
    torch.cuda.synchronize()
    same = bool(torch.equal(codes, want_codes)) and bool(torch.equal(hmax1, want_max))
    print(f"  int8_eps_fused_l12 lin1 pass at Ci = 20, f{tuple(feats.shape)} fp32: codes and max|h1| equal the "
          f"plain version's: {same}")
    assert same, "K5a's lin1 pass at Ci = 20 differs from its plain version"
    args = (feats, y_in, w1, a, c, w_q, s, c)
    held("int8_eps_fused_l12", f"Ci = 20 f{tuple(feats.shape)} fp32", lambda: K.int8_eps_l12(*args),
         lambda: K.int8_eps_l12_plain(*args), args,
         [(2 * m * r * f_ * f_, INT8_OP_PER_S), (2 * m * r * 2 * c_ * f_, FP32_FLOP_PER_S)], 1e-3)
    w4 = rnd(m, f_, c_, lo=-f_**-0.5, hi=f_**-0.5)
    args = (x, xmax, w_q, s, c, colsum, w4)
    held("int8_eps_fused_l34", f"C = 10 h2{tuple(x.shape)} fp32, w4{tuple(w4.shape)}", lambda: K.int8_eps_l34(*args),
         lambda: K.int8_eps_l34_plain(*args), args,
         [(2 * m * r * f_ * f_, INT8_OP_PER_S), (2 * m * r * f_ * c_, FP32_FLOP_PER_S)], 1e-3)


RESULTS_DIR = "_smoke_results"  # beside this script (gitignored), deleted at the end
RESULTS_CORPUS = {"training": 30, "validation": 35, "testing": 35}  # images a class: one batch of 70 to evaluate
RESULTS_EPOCHS = (1, 1)  # stage 1 and stage 3, cut from the evidence run's 80 and 100
RESULTS_TEST_BATCH, RESULTS_VAL_DDIM = 70, 25  # configs/synthetic224.yml's testing batch and val_ddim_steps
PROFILE_REPS = 1  # profile_serving's --reps: 41 calls of the ViT and guidance parts, 2 of each scan
# K3 in a forward of all K + 1 guidance heads: the tap path on the bare patches to block 5, then the full ViT
GUIDANCE_FORWARD = 5 + VIT_DEPTH


def results_step_launches(module: str, argv: list) -> dict:
    """Each kernel's launches in one step of ``run_results`` at
    ``RESULTS_CORPUS`` and ``RESULTS_EPOCHS``, full width (ViT-B/16: K3 12
    times a full forward, 5 for the five mapping heads' taps; K1 three
    times an eps call). Evaluations run one batch of 70, counted twice (the
    graph's eager warm-up, then its replay; ``eval_launches``)."""
    def ceil(n, b):
        return -(-n // b)

    def value(flag):
        return argv[argv.index(flag) + 1]

    e1, e3 = RESULTS_EPOCHS
    n = {k: 2 * v for k, v in RESULTS_CORPUS.items()}
    train_steps = ceil(n["training"], TRAIN_BATCH)
    name = module.rsplit(".", 1)[1]
    if name == "train_transformer":  # the train steps, then the validation split at its eval batch 70
        return {"flash_attention": VIT_DEPTH * (train_steps + ceil(n["validation"], 70)) * e1}
    if name == "train_mapping":  # MLP k taps after block k + 1: train steps and the validation split at 30
        return {"flash_attention": (int(value("--mlp_idx")) + 1) * (train_steps + ceil(n["validation"], 30)) * e1}
    if "--eval_guidance" in argv:  # all K + 1 heads over the validation split
        return {"flash_attention": GUIDANCE_FORWARD * ceil(n["validation"], RESULTS_TEST_BATCH)}
    if "--train" in argv:
        # one validation an epoch here: DDIM-25, one trial, at the sampling batch 70; member 0
        # precomputes the five mapping heads' y0_hat, the others read its cache
        want = {"fused_linear_act": 3 * RESULTS_VAL_DDIM * ceil(n["validation"], 70) * e3}
        if value("--mlp_idx") == "0":
            want["flash_attention"] = 5 * (train_steps + ceil(n["validation"], 70))
        return want
    batches = n["validation" if "--calib" in argv else "testing"] // RESULTS_TEST_BATCH
    if "--suite" not in argv:  # --calib and --test at DDIM-50
        return eval_launches({"fused_linear_act": 3 * 50}, batches)
    with open(value("--suite")) as f:
        rows = json.load(f)
    want = dict.fromkeys(KERNELS, 0)
    for row in rows.values():
        steps = row.get("ddim_steps", 0) or 1000
        if row.get("pallas_fuse_ends"):
            chain = {"int8_eps_fused_l12": steps, "int8_eps_fused_l34": steps}
        elif row.get("use_int8_pallas"):
            chain = {"int8_linear_softplus": 2 * steps}
        else:  # use_int8 runs the torch._int_mm layers
            chain = {} if row.get("use_int8") else {"fused_linear_act": 3 * steps}
        attack = ATTACK_FORWARDS[row["attack_name"]] if row.get("attack_name") else 0
        for k, v in eval_launches(chain, batches, attack).items():
            want[k] += v
    return want


def profile_launches(reps: int) -> dict:
    """``profile_serving --batch 70 --reps reps --int8 --pallas_int8
    --int8_encode`` (DDIM-50): a warm-up and ``reps`` x (40 | 20 | 1)
    calls a part; the served request (a ``Predictor``) counts its first
    call twice."""
    many, some, once = 1 + 40 * reps, 1 + 20 * reps, 1 + reps
    return {"flash_attention": VIT_DEPTH * many + GUIDANCE_FORWARD * (many + once) + 5 * (many + 2 * some + reps + 2),
            "fused_linear_act": 150 * (2 * once + reps + 2), "int8_linear_softplus": 100 * once,
            "int8_eps_fused_l12": 50 * once, "int8_eps_fused_l34": 50 * once}


def run_results_phase():
    """Phase 13, with Pillow's import blocked: (a) the port's
    ``make_synth_medical`` writes ``RESULTS_CORPUS`` through ``data/png.py``
    and ``load_split`` reads it back equal to the generator's pixels; (b)
    ``run_results.run`` at full width with ``RESULTS_EPOCHS`` and the
    ``--fast`` suite, each step's launches held to
    :func:`results_step_launches`, then a second call that runs no step;
    (c) ``profile_serving`` at batch 70. Returns each kernel's launches."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.data.imagefolder import load_split
    from ladine_tpu_torch.examples import make_synth_medical, profile_serving, run_digits, run_results
    from ladine_tpu_torch.metrics import ensemble_confidence

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, RESULTS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    pil = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # as on a machine without Pillow: an import of it raises
    total = dict.fromkeys(KERNELS, 0)
    seconds = {}
    try:
        work = os.path.join(root, "run")

        def counted(module, argv, log_path, done=None):
            if "--test" in argv and "--eval_ema" in argv:
                argv = argv + ["--save_samples"]  # the dump whose probs (a) holds to sum to 1
            before = {k: K.launch_counts[k] for k in KERNELS}
            s = run_digits.run_step(module, argv, log_path, done)
            got = {k: K.launch_counts[k] - before[k] for k in KERNELS if K.launch_counts[k] != before[k]}
            want = {k: v for k, v in results_step_launches(module, argv).items() if v}
            doc = argv[argv.index("--doc") + 1] if "--doc" in argv else module.rsplit(".", 1)[1]
            if doc == "train_mapping":
                doc += " " + argv[argv.index("--mlp_idx") + 1]
            print(f"    {doc}: {s:.1f} s, launches {got}, {gib_now()} after it")
            assert got == want, (module, argv, got, want)
            for k, v in got.items():
                total[k] += v
            seconds[doc] = s
            return s

        t0 = time.perf_counter()
        out = run_results.run(work, "cuda", fast=True, corpus=RESULTS_CORPUS, epochs=RESULTS_EPOCHS, step=counted)
        seconds["(b) run_results"] = time.perf_counter() - t0
        print(f"  (b) run_results at epochs {RESULTS_EPOCHS}, corpus {RESULTS_CORPUS} a class, in "
              f"{seconds['(b) run_results']:.1f} s ({out['steps']} steps): ViT val acc {out['stage1a_vit_val_acc']}, "
              f"MLPs {out['stage1b_mlp_val_accs']}, guidance mv-acc {out['guidance_mv_acc']}; stage seconds "
              + ", ".join(f"{k} {v:.1f}" for k, v in out["stage_seconds"].items()))
        want_rows = {"calib", "calib_ema", "ema", *run_results.suite_dict(True)}
        assert set(out["reports"]) == want_rows, sorted(out["reports"])
        for name, r in sorted(out["reports"].items()):
            n = 2 * RESULTS_CORPUS["validation" if name.startswith("calib") else "testing"]
            keys = ("majority_vote_accuracy", "mean_confidence_accuracy", "ece", "nll", "brier")
            print(f"    {name}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys) + f", {r['num_instances']} images")
            assert r["num_instances"] == n and all(np.isfinite(r[k]) for k in keys), (name, r)
        dump = np.load(os.path.join(work, "exp", "logs", "test_ema", "samples.npz"))
        probs = ensemble_confidence(torch.from_numpy(dump["samples"]), out["reports"]["ema"]["temperature"])
        assert np.isfinite(dump["samples"]).all() and torch.allclose(probs.sum(-1), torch.ones(len(probs)), atol=1e-5)
        print(f"    test_ema samples {dump['samples'].shape}: finite, probs rows sum to 1 "
              f"(max |sum - 1| {float((probs.sum(-1) - 1).abs().max()):.2e})")
        with open(os.path.join(work, "RESULTS_torch.md")) as f:
            assert "| clean, full 1000-step chain (parity workload) | " in f.read()

        # (a) the corpus that (b) wrote through data/png.py, read back through it
        ds = os.path.join(work, "synth_ds")
        rng = np.random.default_rng(0)
        want = []
        for _ in range(3):  # training/NORMAL: each image after its label-noise draw
            rng.random()
            want.append(make_synth_medical.make_image(0, rng))
        got = load_split(ds, "ChestXRay", "train").load_indices([0, 1, 2])
        same = np.array_equal(got, np.stack(want).astype(np.float32) / 255.0)
        print(f"  (a) {sum(len(fs) for _, _, fs in os.walk(ds)) - 1} PNGs written without Pillow "
              f"({dir_bytes(ds) / 2**20:.1f} MiB), corpus {out['stage_seconds']['corpus']:.1f} s; the first "
              f"training images read back equal to the generator's pixels: {same}")
        assert same

        calls = []
        again = run_results.run(work, "cuda", fast=True, corpus=RESULTS_CORPUS, epochs=RESULTS_EPOCHS,
                                step=lambda *a, **k: calls.append(a))
        print(f"  (b) a second call: {again['steps']} steps run")
        assert again["steps"] == 0 and not calls and again["reports"] == out["reports"]
        shutil.rmtree(work)
        free_memory()

        # (c) the serving decomposition at batch 70
        K.launch_counts.clear()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            assert profile_serving.main(["--batch", "70", "--reps", str(PROFILE_REPS), "--int8", "--pallas_int8",
                                         "--int8_encode"]) == 0
        seconds["(c) profile_serving"] = time.perf_counter() - t0
        lines = printed.getvalue().strip().splitlines()
        record = json.loads(lines[-1])
        got = {k: K.launch_counts[k] for k in KERNELS if K.launch_counts[k]}
        print(f"  (c) profile_serving --batch 70 --reps {PROFILE_REPS} (int8, K4, K5, int8 encode) in "
              f"{seconds['(c) profile_serving']:.1f} s on {lines[-2]}: {json.dumps(record)}; launches {got}")
        assert lines[-2] == gpu_line() and record["batch"] == 70
        assert all(np.isfinite(v) and v > 0 for k, v in record.items() if not k.startswith("fixed_cost")), record
        assert got == profile_launches(PROFILE_REPS), (got, profile_launches(PROFILE_REPS))
        for k, v in got.items():
            total[k] += v
    finally:
        if pil is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = pil
        shutil.rmtree(root, ignore_errors=True)
    print("  phase 13 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return total


def check_phase13_shapes(entries):
    """After phase 13 (not counted): K1, K3, K5a and K5b at the evidence
    run's test batch of 70 (20 trials: 1400 rows a member, 5 members), in
    bf16 and in float32, against their plain versions at phase 2's
    tolerances, with their times, bounds and, for K3, SDPA's: K1 lin1 (5,
    1400, 4) -> 4096 (the float32 gate) and lin2/lin3 (5, 1400, 4096) ->
    4096; K3 at (70, 196|197, 12, 64); K5a and K5b at (5, 1400, 4096), the
    rows profile_serving's K5 scan gives them (bf16 on the card) and phase
    2's float32 rows. ``phase13`` lists each record."""
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import int8 as Q

    g = torch.Generator(device="cuda").manual_seed(13)
    by_name = {e["name"]: e for e in entries}
    bf16, f32 = torch.bfloat16, torch.float32
    rate = {bf16: BF16_FLOP_PER_S, f32: FP32_FLOP_PER_S}
    m, r, f_ = 5, 70 * 20, 4096

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=f32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    def held(name, label, fn, plain, inputs, work, tol, library=None):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(compare(f"{name} {label}" + (f" output {i}" if len(got) > 1 else ""), a_, b_, tol)
                  for i, (a_, b_) in enumerate(zip(got, want)))
        rec = dict(max_abs_err=err, ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 10), library_ms=None)
        rec["bound_ms"], rec["bound_by"] = bound((*inputs, *got), *work)
        if library is not None:
            rec["library_ms"] = cuda_ms(library, 20, spin=8_000_000)
        print(f"    ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})" + ("" if library is None else f" library_ms={rec['library_ms']:.4f}"))
        by_name[name].setdefault("phase13", {})[label] = rec
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)

    feats = rnd(m, r, f_)
    a, c = rnd(m, f_, lo=0.5, hi=1.5), rnd(m, f_, lo=-0.5, hi=0.5)
    for dtype, tol in ((f32, 1e-4), (bf16, 2e-2)):
        y_in = rnd(m, r, 4, lo=0.0, hi=1.0, dtype=dtype)
        w1 = rnd(m, 4, f_, lo=-0.5, hi=0.5, dtype=dtype)
        args = (y_in, w1, a, c, feats)
        held("fused_linear_act", f"lin1 y_in{tuple(y_in.shape)} {str(dtype)[6:]}, gate fp32",
             lambda: K.fused_linear_act(*args), lambda: K.fused_linear_act_plain(*args), args,
             [(2 * m * r * 4 * f_, rate[dtype])], tol)
        h = rnd(m, r, f_, lo=0.0, hi=2.0, dtype=dtype)
        w = rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5, dtype=dtype)
        args2 = (h, w, a, c, None)
        held("fused_linear_act", f"lin2/lin3 {tuple(h.shape)}x{tuple(w.shape)} {str(dtype)[6:]}",
             lambda: K.fused_linear_act(*args2), lambda: K.fused_linear_act_plain(*args2), args2[:4],
             [(2 * m * r * f_ * f_, rate[dtype])], tol)
    b, h_, d = 70, 12, 64
    for n in (196, 197):  # the taps' bare patches; the classifier's patches and cls token
        for dtype, tol in ((f32, 1e-4), (bf16, 2e-2)):
            qkv = rnd(b, n, 3, h_, d, lo=-2.0, hi=2.0, dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            held("flash_attention", f"{(b, n, h_, d)} {str(dtype)[6:]}", lambda: K.flash_attention(q, k, v),
                 lambda: K.flash_attention_plain(q, k, v), (q, k, v), [(4 * b * h_ * n * n * d, rate[dtype])], tol,
                 library=lambda: F.scaled_dot_product_attention(qt, kt, vt))
    # K5: the int8 codes and their sums are exact; h differs where softplus
    # rounds apart, by one bf16 step in the bf16 rows
    w_q, w_scale = Q.quantize_weight(rnd(m, f_, f_, lo=-f_**-0.5, hi=f_**-0.5))
    s, colsum = (w_scale * a).contiguous(), w_q.sum(dim=1, dtype=torch.int32).float()
    for dtype, tol in ((f32, 1e-3), (bf16, 2e-2)):
        f, label = feats.to(dtype), str(dtype)[6:]
        y_in = rnd(m, r, 4, lo=0.0, hi=1.0, dtype=dtype)
        w1 = rnd(m, 4, f_, lo=-0.5, hi=0.5, dtype=dtype)
        args = (f, y_in, w1, a, c, w_q, s, c)
        held("int8_eps_fused_l12", f"f{tuple(f.shape)} {label}, w2{tuple(w_q.shape)} int8",
             lambda: K.int8_eps_l12(*args), lambda: K.int8_eps_l12_plain(*args), args,
             [(2 * m * r * f_ * f_, INT8_OP_PER_S), (2 * m * r * 4 * f_, FP32_FLOP_PER_S)], tol)
        h2 = rnd(m, r, f_, lo=0.0, hi=2.0, dtype=dtype)
        hmax2 = h2.float().amax(-1, keepdim=True).contiguous()
        w4 = rnd(m, f_, 2, lo=-f_**-0.5, hi=f_**-0.5, dtype=dtype)
        args2 = (h2, hmax2, w_q, s, c, colsum, w4)
        held("int8_eps_fused_l34", f"h2{tuple(h2.shape)} {label}, w3{tuple(w_q.shape)} int8, w4{tuple(w4.shape)}",
             lambda: K.int8_eps_l34(*args2), lambda: K.int8_eps_l34_plain(*args2), args2,
             [(2 * m * r * f_ * f_, INT8_OP_PER_S), (2 * m * r * f_ * 2, FP32_FLOP_PER_S)], tol)


def main() -> int:
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this script runs only on an NVIDIA card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ladine_tpu_torch")):
        return fail(f"the ladine_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, here)
    from ladine_tpu_torch.kernels import _build

    start = time.perf_counter()
    print("== phase 1: environment and build")
    card = gpu_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    sources = sorted(n[:-3] for n in os.listdir(_build.CSRC_DIR) if n.endswith(".cu"))
    logs = _build.build(sources)
    print(f"  built {sources} in {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    print_registers(logs)

    print("== phase 2: kernels vs plain versions at the path's shapes and dtypes")
    entries = check_kernels() + check_int8_kernels()
    print(f"== phase 3: small fp32 predictor, card vs CPU [{time.perf_counter() - start:.0f} s]")
    check_small_against_cpu()
    print(f"== phase 4: full-width serving path (parity, serving and fast presets) [{time.perf_counter() - start:.0f} s]")
    launches, full = run_full_width()
    print(f"== phase 5: reference state dicts, save and load, the batcher (full width) [{time.perf_counter() - start:.0f} s]")
    artifact_launches = run_artifact_surface(**full)
    print(f"== phase 6: the AOT bundle: export_serving, ExportedPredictor, the batcher (full width) [{time.perf_counter() - start:.0f} s]")
    bundle_launches = run_bundles(**full)
    print(f"== phase 7: robust evaluation at full width (corruptions, PGD, three operating points; "
          f"the attacks) [{time.perf_counter() - start:.0f} s]")
    eval_launches = run_evaluation(**full)
    print(f"== phase 8: training at full width (member steps fp32 and lowmem, the EMA, the hand-off, the ViT "
          f"and mapping trainers, the joint step, the GMM posterior) [{time.perf_counter() - start:.0f} s]")
    from ladine_tpu_torch import kernels as K

    t8 = time.perf_counter()
    K.launch_counts.clear()
    train_launches = run_training(full)
    print(f"  phase 8 in {time.perf_counter() - t8:.0f} s; launches {train_launches}")
    print("  phase 8's kernels against their plain versions at its shapes (not counted)")
    check_training_shapes(entries)
    print(f"== phase 9: the command-line pipeline at full width (train_transformer, train_mapping, assemble, "
          f"main --train, --test, --suite, --calib) [{time.perf_counter() - start:.0f} s]")
    sched, images = full["sched"], full["images"]
    full.clear()
    free_memory()
    t9 = time.perf_counter()
    seconds10 = {}

    def stage1_backbones(root, data):
        print(f"  phase 9 in {time.perf_counter() - t9:.0f} s")
        print(f"== phase 10: the rest of the single-card surface at full width: (b) the stage-1 backbones on "
              f"phase 9's corpus [{time.perf_counter() - start:.0f} s]")
        t = time.perf_counter()
        out = run_stage1_backbones(root, data)
        seconds10["(b)"] = time.perf_counter() - t
        return out

    cli_launches, backbone_launches = run_cli_pipeline(then=stage1_backbones)
    print(f"  phase 9 launches {cli_launches}")
    print(f"  (a) F5: guidance-free members (--no_cat_f_phi) [{time.perf_counter() - start:.0f} s]")
    t = time.perf_counter()
    f5_launches = run_f5(sched, images)
    seconds10["(a)"] = time.perf_counter() - t
    print(f"  (c) the encoder archs [{time.perf_counter() - start:.0f} s]")
    t = time.perf_counter()
    encoder_launches = run_encoder_archs(sched, images)
    seconds10["(c)"] = time.perf_counter() - t
    phase10_launches = {k: backbone_launches[k] + f5_launches[k] + encoder_launches[k] for k in KERNELS}
    print(f"  phase 10 seconds by sub-phase: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(seconds10.items()))
          + f"; launches (a) {f5_launches}, (b) {backbone_launches}, (c) {encoder_launches}")
    print("  phase 9's kernels against their plain versions at its new shapes (not counted)")
    check_cli_shapes(entries)
    print("  phase 10's kernels against their plain versions at its new shapes (not counted)")
    check_phase10_shapes(entries)
    print(f"== phase 11: the mesh at full width, two gloo ranks sharing the card: (a) serving, (c) evaluate_ensemble, "
          f"(b) train steps [{time.perf_counter() - start:.0f} s]")
    free_memory()
    t11 = time.perf_counter()
    mesh_launches = run_mesh()
    t = time.perf_counter()
    print("  phase 11's kernels against their plain versions at a rank's shapes (not counted)")
    check_phase11_shapes(entries)
    print(f"  phase 11 in {time.perf_counter() - t11:.0f} s (the shape checks {time.perf_counter() - t:.1f} s); "
          f"launches a rank {mesh_launches}")
    print(f"== phase 12: the 10-class real-data path at configs/digits.yml's widths: (a) run_digits, (b) the int8 "
          f"test rows, (c) the bf16 path [{time.perf_counter() - start:.0f} s]")
    free_memory()
    t12 = time.perf_counter()
    digits_launches = run_digits_phase()
    t = time.perf_counter()
    print("  phase 12's kernels against their plain versions at the digits shapes (not counted)")
    check_phase12_shapes(entries)
    print(f"  phase 12 in {time.perf_counter() - t12:.0f} s (the shape checks {time.perf_counter() - t:.1f} s); "
          f"launches {digits_launches}")
    print(f"== phase 13: the evidence pipeline at full width without Pillow: (a) the synthetic corpus, "
          f"(b) run_results, (c) profile_serving [{time.perf_counter() - start:.0f} s]")
    free_memory()
    t13 = time.perf_counter()
    results_launches = run_results_phase()
    t = time.perf_counter()
    print("  phase 13's kernels against their plain versions at the batch-70 shapes (not counted)")
    check_phase13_shapes(entries)
    print(f"  phase 13 in {time.perf_counter() - t13:.0f} s (the shape checks {time.perf_counter() - t:.1f} s); "
          f"launches {results_launches}")
    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
        e["artifact_launches"] = artifact_launches.get(e["name"], 0)
        e["bundle_launches"] = bundle_launches.get(e["name"], 0)
        e["eval_launches"] = eval_launches.get(e["name"], 0)
        e["train_launches"] = train_launches.get(e["name"], 0)
        e["cli_launches"] = cli_launches.get(e["name"], 0)
        e["phase10_launches"] = phase10_launches.get(e["name"], 0)
        e["phase11_launches"] = mesh_launches.get(e["name"], 0)
        e["phase12_launches"] = digits_launches.get(e["name"], 0)
        e["phase13_launches"] = results_launches.get(e["name"], 0)
        if 0 in (e["launches"], e["eval_launches"], e["train_launches"], e["cli_launches"], e["phase10_launches"],
                 e["phase11_launches"], e["phase12_launches"], e["phase13_launches"]):
            raise AssertionError(f"{e['name']} was never launched on the main path")
    print(f"  all phases in {time.perf_counter() - start:.0f} s")

    print(json.dumps({"kernels": entries}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
