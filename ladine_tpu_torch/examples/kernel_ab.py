"""Time K1's float32 lin2/lin3 and its lin1 (``fused_linear_act``), K3
(``flash_attention``), K4 (``int8_linear_softplus``), K5a (``int8_eps_l12``)
and K5b (``int8_eps_l34``) of two or more checkouts of the port on one card,
in turns, so that a change to a kernel is compared with its parent on the
same card in the same call.

    python ladine_tpu_torch/examples/kernel_ab.py --roots PARENT . [--kinds lin1 requests] [--out FILE]

Each root is a directory that holds a ``ladine_tpu_torch`` package (a
checkout, or a ``git archive`` of one). Each runs in a process of its own,
which builds that root's kernels from its sources, in the order of
``--roots`` and then reversed (A, B, B, A). A process times each kernel on
the same seeded inputs: K1 in float32 at (5, R, 4096) -> 4096 with R = 160
(batch 8) and 1400 (batch 70), without a gate, with its body
(``fused_linear.plan``) and its error and the plain version's against a
float64 product; K3 in bfloat16 and float32 on the strided slices of
a fused qkv projection at the serving batch 8 (196 tokens), a training
batch 30 (197 tokens; 12 heads of 64 and ConViT's 16 of 48) and the
evidence batch 70 (197); K4 in both schemes (lin2 symmetric, lin3
zero-point), K5a (lin1 at Ci = 4, then lin2) and K5b (lin3, then lin4 at
N = 2) at (5, R, 4096) -> 4096 with R = 160 (batch 8) and 1400 (batch 70),
on float32 and bfloat16 rows; device time by CUDA events over
back-to-back calls behind a spin kernel, and each output's largest
difference from the plain version. K4's and K5a's outputs (h and its row
max) must be the same bits in every root: the script exits 1 where they
differ. A root whose K1 has the ``tf32x3`` body also times it against
``simt`` through their C entries at K1's float32 shapes from the digits'
K = 64 to K = 4096 (where ``fused_linear.SIMT_MAX_K`` comes from). Last,
each root serves graphed ``parity`` requests of batch 8 at full width
(random weights from a seed: the bf16 guidance, five members in float32,
then in bf16), three after the capture.
K1's lin1 (``lin1``): K = 4 at (5, 160) -> 4096 (batch 8, 20 trials) in
bf16 (the float32 features as the gate) and float32, with the gate a row a
row (5, 160, 4096) and, in a root whose ``fused_linear_act`` takes it, a
row an image (5, 8, 4096), the float chain's; and the digits' K = 20 at
(5, 640) -> 64 (64 images, 10 trials) in both dtypes. The K = 4 outputs of
each root are compared with the first root's: the script reports whether
they are the same bits and the largest difference where not. A root with
``fused_linear.small_k_plan`` also times, through the C entries in turns,
the small_k body at K = 20 against the body the digits' lin1 took before
it (``mma`` in bf16, ``simt`` in float32).
``--kinds`` picks what runs (default: all of ``KINDS``).
The card's name and power limit lead the output; the last line is the JSON
record of every run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

K3_SHAPES = ((8, 196, 12, 64), (30, 197, 12, 64), (30, 197, 16, 48), (70, 197, 12, 64))
INT8_ROWS = (160, 1400)
K1_ROWS = (160, 1400)
# K1 float32 (M, R, K = N) shapes where a root with the tf32x3 body times it against simt
BODY_SHAPES = ((5, 640, 64), (1, 4100, 64), (5, 640, 256), (5, 160, 1024), (5, 160, 2048), (5, 160, 4096))
KINDS = ("k1", "lin1", "k3", "k4", "k5a", "k5b", "requests")
# K1 lin1 shapes: (M, images, trials, K, N), the path's batch 8 and the digits'
LIN1_SHAPES = ((5, 8, 20, 4, 4096), (5, 64, 10, 20, 64))


def _cuda_ms(torch, fn, iters: int, spin: int = 1_000_000) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * spin)  # holds the stream while the host enqueues the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes: equal digests, equal bits."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def worker(root: str, kinds=KINDS, save=None) -> dict:
    """Times of the kernels of the package under ``root``; ``save``: a
    file for the K = 4 lin1 outputs (compared across roots)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.kernels import fused_linear
    from ladine_tpu_torch.kernels import int8 as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape, lo=-1.0, hi=1.0, dtype=torch.float32):
        return torch.empty(*shape, device="cuda").uniform_(lo, hi, generator=g).to(dtype)

    out = {"root": root, "package": os.path.dirname(K.__file__), **{kind: {} for kind in KINDS if kind != "requests"}}
    if "lin1" in kinds:
        out["lin1"], outputs = _lin1(torch, K, fused_linear)
        if save:
            torch.save(outputs, save)
    if "k1" not in kinds:
        return _rest(torch, K, Q, rnd, out, kinds)
    w1 = rnd(5, 4096, 4096, lo=-4096**-0.5, hi=4096**-0.5)
    a1, c1 = rnd(5, 4096, lo=0.5, hi=1.5), rnd(5, 4096, lo=-0.5, hi=0.5)
    for r in K1_ROWS:
        args = (rnd(5, r, 4096, lo=0.0, hi=2.0), w1, a1, c1, None)
        got, plain = K.fused_linear_act(*args), K.fused_linear_act_plain(*args)
        ref = torch.nn.functional.softplus(torch.matmul(args[0].double(), w1.double()) * a1.double().unsqueeze(1)
                                           + c1.double().unsqueeze(1))
        out["k1"][f"R={r} float32"] = dict(ms=_cuda_ms(torch, lambda: K.fused_linear_act(*args), 20),
                                           max_abs_err=float((got - plain).abs().max()),
                                           err_float64=float((got.double() - ref).abs().max()),
                                           plain_err_float64=float((plain.double() - ref).abs().max()),
                                           body=fused_linear.plan(torch.float32, 4096, 4096, True)[0])
    if hasattr(fused_linear, "TF32_STEP_K"):  # a root with the tf32x3 body
        out["bodies"] = _bodies(torch, fused_linear)
    return _rest(torch, K, Q, rnd, out, kinds)


def _rest(torch, K, Q, rnd, out, kinds) -> dict:
    """K3, K4, K5a, K5b and the requests, as ``kinds`` asks."""
    for b, n, h, d in K3_SHAPES if "k3" in kinds else ():
        for dtype in (torch.bfloat16, torch.float32):
            qkv = rnd(b, n, 3, h, d, lo=-2.0, hi=2.0, dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            err = (K.flash_attention(q, k, v).float() - K.flash_attention_plain(q, k, v).float()).abs().max()
            out["k3"][f"{(b, n, h, d)} {str(dtype)[6:]}"] = dict(
                ms=_cuda_ms(torch, lambda: K.flash_attention(q, k, v), 50), max_abs_err=float(err))
    if not {"k4", "k5a", "k5b"} & set(kinds):
        if "requests" in kinds:
            out["requests"] = _requests(torch)
        return out
    m, k_, n_, c = 5, 4096, 4096, 2
    w_q, w_scale = Q.quantize_weight(rnd(m, k_, n_, lo=-k_**-0.5, hi=k_**-0.5))
    colsum = w_q.sum(dim=1, dtype=torch.int32).float()
    s, c3 = (w_scale * rnd(m, n_, lo=0.5, hi=1.5)).contiguous(), rnd(m, n_, lo=-0.5, hi=0.5)
    a1, c1 = rnd(m, k_, lo=0.5, hi=1.5), rnd(m, k_, lo=-0.5, hi=0.5)
    for r in INT8_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            rows = f"R={r} {str(dtype)[6:]} rows"
            for scheme, lo, cs in (("symmetric", -2.0, None), ("zero-point", 0.0, colsum)):
                x = rnd(m, r, k_, lo=lo, hi=2.0, dtype=dtype)
                xf = x.float()
                xmax = (xf.amax(-1, keepdim=True) if cs is not None else xf.abs().amax(-1, keepdim=True)).contiguous()
                args = (x, xmax, w_q, s, c3, cs)
                got = K.int8_linear_softplus(*args)
                err = max((g_.float() - p_.float()).abs().max().item()
                          for g_, p_ in zip(got, K.int8_linear_softplus_plain(*args)))
                out["k4"][f"{rows} {scheme}"] = dict(
                    ms=_cuda_ms(torch, lambda: K.int8_linear_softplus(*args), 50), max_abs_err=err,
                    digest=_digest(got))
            f = rnd(m, r, k_, dtype=dtype)
            args = (f, rnd(m, r, 4, lo=0.0, hi=1.0, dtype=dtype), rnd(m, 4, k_, lo=-0.5, hi=0.5, dtype=dtype),
                    a1, c1, w_q, s, c3)
            got = K.int8_eps_l12(*args)
            err = max((g_.float() - p_.float()).abs().max().item() for g_, p_ in zip(got, K.int8_eps_l12_plain(*args)))
            out["k5a"][rows] = dict(ms=_cuda_ms(torch, lambda: K.int8_eps_l12(*args), 50), max_abs_err=err,
                                    digest=_digest(got))
            h2 = rnd(m, r, k_, lo=0.0, hi=2.0, dtype=dtype)
            args = (h2, h2.float().amax(-1, keepdim=True).contiguous(), w_q, s, c3, colsum,
                    rnd(m, n_, c, lo=-n_**-0.5, hi=n_**-0.5, dtype=dtype))
            first = K.int8_eps_l34(*args)
            err = (first - K.int8_eps_l34_plain(*args)).abs().max()
            out["k5b"][rows] = dict(
                ms=_cuda_ms(torch, lambda: K.int8_eps_l34(*args), 50), max_abs_err=float(err),
                repeats_bit_for_bit=bool(torch.equal(first, K.int8_eps_l34(*args))))
    if "requests" in kinds:
        out["requests"] = _requests(torch)
    return out


def _lin1(torch, K, fl):
    """K1's lin1 at LIN1_SHAPES in bf16 and float32, with the gate a row a
    row and (where the root takes it) a row an image: ms, body, the largest
    difference from the plain version; the K = 4 outputs by label. A root
    with the small_k plan also times the K = 20 bodies (:func:`_lin1_bodies`).
    Its own generator."""
    g = torch.Generator(device="cuda").manual_seed(19)
    image_gate = hasattr(fl, "small_k_plan")
    rec, outputs = {}, {}
    for m, images, trials, k, n in LIN1_SHAPES:
        r = images * trials
        f_img = torch.empty(m, images, n, device="cuda").uniform_(-1.0, 1.0, generator=g)
        f_row = f_img.unsqueeze(1).expand(m, trials, images, n).reshape(m, r, n).contiguous()
        a = torch.empty(m, n, device="cuda").uniform_(0.5, 1.5, generator=g)
        c = torch.empty(m, n, device="cuda").uniform_(-0.5, 0.5, generator=g)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.empty(m, r, k, device="cuda").uniform_(0.0, 1.0, generator=g).to(dtype)
            w = torch.empty(m, k, n, device="cuda").uniform_(-0.5, 0.5, generator=g).to(dtype)
            for gate in (f_row, f_img) if image_gate else (f_row,):
                args = (x, w, a, c, gate)
                key = f"{str(dtype)[6:]} K={k} {(m, r, n)}, gate {tuple(gate.shape)}"
                got = K.fused_linear_act(*args)
                rec[key] = dict(ms=_cuda_ms(torch, lambda: K.fused_linear_act(*args), 200),
                                max_abs_err=float((got.float() - K.fused_linear_act_plain(*args).float()).abs().max()),
                                body=fl.plan(dtype, k, n, True)[0])
                if k == 4:
                    outputs[key] = got.cpu()
            if image_gate and k > 4:
                rec.update(_lin1_bodies(torch, fl, x, w, a, c, f_img, images))
    return rec, outputs


def _lin1_bodies(torch, fl, x, w, a, c, f_img, images) -> dict:
    """At the digits' K = 20: the small_k body against the body the digits'
    lin1 took before it (``mma`` in bf16, ``simt`` in float32, with the gate
    a row a row), through their C entries in turns (A B B A): ms each and
    the largest difference from the plain version."""
    m, r, k = x.shape
    n = w.shape[2]
    bf16 = x.dtype == torch.bfloat16
    old = "mma" if bf16 else "simt"
    stream = torch.cuda.current_stream().cuda_stream
    p = fl.small_k_plan(m, r, k, n)
    f_row = f_img.unsqueeze(1).expand(m, r // images, images, n).reshape(m, r, n).contiguous()
    ref = fl.fused_linear_act_plain(x, w, a, c, f_img)
    outs = {name: torch.empty_like(ref) for name in ("small_k", old)}
    ptrs = (x.data_ptr(), w.data_ptr(), a.data_ptr(), c.data_ptr())
    calls = {
        "small_k": lambda: fl._small_k_lib()(*ptrs, f_img.data_ptr(), outs["small_k"].data_ptr(), m, r, images, k, n,
                                             int(bf16), int(bf16), 1, p.tx, p.strips, p.splits, p.grid, stream),
        old: lambda: fl._lib()(*ptrs, f_row.data_ptr(), outs[old].data_ptr(), m, r, k, n, int(bf16), int(bf16),
                               int(not bf16), fl._BODIES[old], stream),
    }
    times = {name: [] for name in calls}
    for name in ("small_k", old, old, "small_k"):
        if calls[name]() != 0:
            raise RuntimeError(f"K1 lin1 {name} launch failed at {(m, r, k, n)}")
        times[name].append(_cuda_ms(torch, calls[name], 200))
    return {f"{str(x.dtype)[6:]} K={k} {(m, r, n)} body {name}": dict(
        ms=min(times[name]), ms_turns=times[name], max_abs_err=float((outs[name].float() - ref.float()).abs().max()),
        body=name) for name in calls}


def _requests(torch) -> dict:
    """Three graphed parity requests of batch 8 (after the capture) on
    float32 members and on bf16 members, behind one bf16 guidance: ms each
    and K1's launches over the three."""
    import time

    import numpy as np

    import ladine_tpu_torch as L
    from ladine_tpu_torch import kernels as K
    from ladine_tpu_torch.models import init_random_

    guidance = init_random_(L.SEViTGuidance(device="cuda", dtype=torch.bfloat16),
                            torch.Generator(device="cuda").manual_seed(0))
    sched = L.DiffusionSchedule.create("linear", 1000, 1e-4, 0.02, device="cuda")
    images = np.random.default_rng(0).random((8, 224, 224, 3), dtype="float32")
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_random_(L.ConditionalModel(5, device="cuda", dtype=dtype),
                             torch.Generator(device="cuda").manual_seed(1))
        pred = L.Predictor.from_preset("parity", guidance=guidance, model=model, sched=sched, mc_trials=20)
        pred.predict(images)  # the capture
        K.launch_counts.clear()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(images)
            ms.append((time.perf_counter() - t0) * 1e3)
        rec[f"parity {str(dtype)[6:]} members"] = dict(graph_ms=ms, k1_launches=K.launch_counts["fused_linear_act"])
        del pred, model
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True, help="checkouts of the port, compared in turns")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS, help="what to time (default: all)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.kinds, args.save)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    runs, scratch = [], tempfile.mkdtemp(prefix="kernel_ab_")
    saved = []
    for root in list(args.roots) + list(reversed(args.roots)):
        saved.append(os.path.join(scratch, f"lin1_{len(saved)}.pt"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--roots", root, "--worker", root,
                               "--save", saved[-1], "--kinds", *args.kinds], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        for kind in KINDS[:-1]:  # the requests below
            for key, rec in runs[-1].get(kind, {}).items():
                print(f"{root}: {kind} {key}: {rec['ms']:.4f} ms, max_abs_err {rec['max_abs_err']:.3e}"
                      + (f", body {rec['body']}" if kind == "lin1" else "")
                      + (f", repeats bit for bit: {rec['repeats_bit_for_bit']}" if kind == "k5b" else "")
                      + (f", body {rec['body']}, against float64 {rec['err_float64']:.3e} (plain "
                         f"{rec['plain_err_float64']:.3e})" if kind == "k1" else ""))
        for shape, rec in runs[-1].get("bodies", {}).items():
            print(f"{root}: K1 float32 {shape}: " + ", ".join(f"{name} {min(r['ms']):.4f} ms" for name, r in rec.items()))
        for name, rec in runs[-1].get("requests", {}).items():
            print(f"{root}: {name}: graphed {', '.join(f'{t:.1f}' for t in rec['graph_ms'])} ms, "
                  f"K1 launches {rec['k1_launches']}")
    # K4 and K5a store h from exact int32 sums with the same arithmetic: every root the same bits
    differ = sorted({f"{kind} {key}" for run in runs for kind in ("k4", "k5a") for key, rec in run[kind].items()
                     if rec["digest"] != runs[0][kind][key]["digest"]})
    print("K4 and K5a outputs equal bit for bit in every root" if not differ else f"outputs DIFFER: {differ}")
    record = {"card": card, "runs": runs, "k4_k5a_bit_equal": not differ}
    if "lin1" in args.kinds:
        record["lin1_k4_vs_first_root"] = _compare_lin1(torch, saved, args.roots)
    for path in saved:
        if os.path.exists(path):
            os.remove(path)
    os.rmdir(scratch)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 1 if differ else 0


def _compare_lin1(torch, saved, roots) -> dict:
    """Each run's K = 4 lin1 outputs against the first root's first run:
    the same bits, or the largest difference (the gate a row an image is
    held against the first root's gate a row a row)."""
    first = torch.load(saved[0])
    want = {key.split(", gate")[0]: t for key, t in first.items()}
    rec = {}
    for i, path in enumerate(saved[1:], 1):
        root = (list(roots) + list(reversed(roots)))[i]
        for key, t in torch.load(path).items():
            ref = want[key.split(", gate")[0]]
            same = torch.equal(t, ref)
            diff = float((t.float() - ref.float()).abs().max())
            rec[f"run {i} ({root}) {key}"] = dict(same_bits=same, max_abs_diff=diff)
            print(f"lin1 K = 4 {key}, run {i} ({root}) against {roots[0]}: "
                  + ("the same bits" if same else f"differs, largest difference {diff:.3e}"))
    return rec


if __name__ == "__main__":
    sys.exit(main())
