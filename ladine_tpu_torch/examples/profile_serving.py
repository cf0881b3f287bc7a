"""Decompose a serving request (DDIM-50 by default) into its parts on the
card: the port's ``scripts/profile_serving.py``, with its flags and the
keys of its JSON record.

  vit_only      the bare ViT forward (no taps, no mapping heads)
  guidance      the guidance forward: the ViT with its taps and all K + 1 heads
  guidance_subset  the serving head set alone (the K mapping heads, ``heads_subset``)
  encode        the members' encoders
  scan_only     ``nested_ensemble_sample`` on given y0_hat (no guidance)
  full          guidance (all heads) + sampling
  full_subset   a ``Predictor.predict`` request: host images in, the
                serving program's CUDA graph (the mapping heads + sampling), outputs out

``full - scan_only`` is the guidance's share. ``--int8`` adds the
``torch._int_mm`` scan, ``--pallas_int8`` the K4 (``scan_pallas_int8``) and
K5 (``scan_pallas_v2``) scans, ``--int8_encode`` the resident-int8 encode,
taps and heads of the ``fast`` preset. The int8 forms are quantized once,
as ``Predictor`` holds them. Each function is timed as the port serves it:
a warm-up call, then ``--reps`` (x 40 for the ViT and guidance, x 20 for
the encoders and int8 parts) calls on distinct inputs, synchronized.

Weights are the JAX script's deterministic constants (``materialize``: the
i-th leaf of a variable tree in flax's order is ``0.02 ((i % 7) - 3) / 3``,
every member the same, BatchNorm statistics ``|x| + 1``), random-free, so
both scripts time the same numbers. bf16 on the card, float32 on the CPU.

    python -m ladine_tpu_torch.examples.profile_serving [--ddim 50] [--reps 10] [--batch 70] [--device cpu --tiny]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ladine_tpu_torch.device import card_line, resolve_device
from ladine_tpu_torch.utils.convert import flax_leaf_order


@torch.no_grad()
def materialize(module: torch.nn.Module, kind: str, scale: float = 0.02) -> None:
    """The JAX script's constants into ``module`` (an ``SEViTGuidance``,
    ``kind="guidance"``, or a stacked ``ConditionalModel``, ``"members"``)."""
    state = module.state_dict()
    for i, key in enumerate(flax_leaf_order(state, kind), start=1):
        state[key].fill_(scale * ((i % 7) - 3) / 3.0)
    if kind == "members":
        for key, t in state.items():
            if key.endswith(("running_mean", "running_var")):
                t.abs_().add_(1.0)


def timeit(fn, reps: int, argsets, device: torch.device) -> float:
    """Seconds a call: one warm-up, then ``reps`` calls cycling through
    ``argsets`` (distinct inputs each rep), waited for."""
    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*argsets[0])
    wait()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*argsets[i % len(argsets)])
    wait()
    return (time.perf_counter() - t0) / reps


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ddim", type=int, default=50)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=70)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--members", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--pallas", action="store_true",
                    help="accepted and changes nothing: the port's ViT always runs its attention kernel (K3)")
    ap.add_argument("--int8", action="store_true", help="also time the torch._int_mm int8 scan")
    ap.add_argument("--int8_encode", action="store_true",
                    help="also time the resident-int8 encode, taps and mapping heads (the fast preset's fixed cost)")
    ap.add_argument("--pallas_int8", action="store_true",
                    help="also time the K4 (use_int8_pallas) and K5 (+ pallas_fuse_ends) scans")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true")
    return ap


@torch.inference_mode()
def profile(args) -> dict:
    """The record of the JAX script's keys, in ms (2 decimals)."""
    from ladine_tpu_torch.infer import Predictor, nested_ensemble_sample
    from ladine_tpu_torch.kernels.int8 import (
        int8_encode,
        int8_mapping_heads,
        quantize_encoder,
        quantize_mapping_heads,
        quantize_member,
    )
    from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance
    from ladine_tpu_torch.ops import DiffusionSchedule, ddim_timesteps

    dev = resolve_device(args.device)
    if args.tiny:
        img, patch, embed, heads_n, depth = 32, 8, 32, 4, args.members
        feat, mlp_dims, T = 64, (64, 32, 16), 50
        args.batch, args.trials = 8, 4
    else:
        img, patch, embed, heads_n, depth = 224, 16, 768, 12, 12
        feat, mlp_dims, T = 4096, (4096, 2048, 128), 1000
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    M, B, K = args.members, args.batch, args.trials
    guidance = SEViTGuidance(num_classes=2, num_members=M, vit_depth=depth, img_size=img, patch_size=patch,
                             embed_dim=embed, num_heads=heads_n, mlp_hidden_dims=mlp_dims, device=dev, dtype=dtype)
    cond = ConditionalModel(M, img * img * 3, feat, feat, 2, T + 1, device=dev, dtype=dtype)
    materialize(guidance, "guidance")
    materialize(cond, "members")
    guidance.eval()
    cond.eval()
    sched = DiffusionSchedule.create("linear", T, 1e-4, 0.02, device=dev)
    tau = ddim_timesteps(T, args.ddim).tolist()
    subset = tuple(range(M))  # the serving head set: the mapping heads

    g = torch.Generator().manual_seed(0)
    images = torch.rand((B, img, img, 3), generator=g).to(dev)
    n_var = 8  # distinct inputs each rep
    img_vars = [images + (i + 1) * 1e-6 for i in range(n_var)]
    yh_vars = [torch.full((M, B, 2), 0.5 + (i + 1) * 1e-7, device=dev) for i in range(n_var)]
    gens = [torch.Generator(device=dev).manual_seed(3 + i) for i in range(n_var)]

    def scan(**flags):
        def fn(yh, gen, x=images.reshape(B, -1)):
            return nested_ensemble_sample(cond, x, yh, sched, mc_trials=K, tau=tau, eta=args.eta, generator=gen,
                                          **flags)
        return fn, [(yh, gen) for yh, gen in zip(yh_vars, gens)]

    def full(im, gen):
        # all K + 1 heads, then the chain behind the mapping heads
        heads = guidance(im)
        yh = torch.softmax(heads.float(), dim=-1)[:M]
        return nested_ensemble_sample(cond, im.reshape(B, -1), yh, sched, mc_trials=K, tau=tau, eta=args.eta,
                                      generator=gen)

    # a served request: host images in, the graphed serving program, host outputs
    pred = Predictor(guidance=guidance, model=cond, sched=sched, mc_trials=K, ddim_steps=args.ddim,
                     ddim_eta=args.eta, device=dev)
    host_vars = [im.cpu().numpy() for im in img_vars]

    q = quantize_member(cond)
    rows = [
        ("vit_only_ms", guidance.vit_logits, [(im,) for im in img_vars], 40),
        ("guidance_ms", guidance, [(im,) for im in img_vars], 40),
        ("guidance_subset_ms", lambda im: guidance.heads_subset(im, subset), [(im,) for im in img_vars], 40),
        ("encode_ms", cond.encode, [(im.reshape(B, -1),) for im in img_vars], 20),
        ("scan_only_ms", *scan(), 1),
    ]
    if args.int8:
        rows.append(("scan_int8_ms", *scan(use_int8_eps=True, qmember=q), 1))
    if args.pallas_int8:
        rows.append(("scan_pallas_int8_ms", *scan(use_int8_pallas=True, qmember=q), 1))
        rows.append(("scan_pallas_v2_ms", *scan(use_int8_pallas=True, pallas_fuse_ends=True, qmember=q), 1))
    if args.int8_encode:
        qenc, qheads = quantize_encoder(cond), quantize_mapping_heads(guidance, subset)
        rows += [
            ("encode_int8_ms", lambda x: int8_encode(cond, x, qenc), [(im.reshape(B, -1),) for im in img_vars], 20),
            ("taps_subset_ms", lambda im: guidance.taps_subset(im, subset), [(im,) for im in img_vars], 20),
            ("heads_int8_ms", lambda im: int8_mapping_heads(guidance, guidance.taps_subset(im, subset), subset,
                                                            qheads), [(im,) for im in img_vars], 20),
        ]
    rows += [
        ("full_ms", full, list(zip(img_vars, gens)), 1),
        ("full_subset_ms", lambda x, gen: pred.predict(x, generator=gen), list(zip(host_vars, gens)), 1),
    ]
    results = {}
    for name, fn, argsets, mult in rows:
        t = timeit(fn, args.reps * mult, argsets, dev) * 1e3
        results[name] = round(t, 2)
        print(f"[profile] {name}: {t:.2f} ms", file=sys.stderr)
    results["fixed_cost_ms"] = round(results["full_ms"] - results["scan_only_ms"], 2)
    results["fixed_cost_subset_ms"] = round(results["full_subset_ms"] - results["scan_only_ms"], 2)
    results["batch"] = B
    results["img_per_sec_full"] = round(B / (results["full_ms"] / 1e3), 1)
    results["img_per_sec_subset"] = round(B / (results["full_subset_ms"] / 1e3), 1)
    return results


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(card_line(resolve_device(args.device)))
    print(json.dumps(profile(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
