"""Nested-ensemble robust evaluation: the reference's ``test_atk``.

Counterpart of ``ladine_tpu/infer/evaluator.py``. Per batch:

1. corruptions in the reference's fixed order (``ops/corruptions.py``);
2. an optional white-box attack on the full ViT (``SEViTGuidance.vit_logits``),
   eager, through ``torch.autograd`` (K3 has a gradient formula);
3. the serving program's raw samples (``ServingProgram.samples``): the
   guidance heads (int8 heads under ``use_int8_encode``), their softmax,
   then every member x MC trial x image's reverse chain. On the card it runs
   as one CUDA graph per batch shape (``infer/graphs.py``), tail batches
   included, as ``Predictor.predict`` runs the same program.

The host keeps the samples and computes the metric block
(``compute_report``): majority-vote accuracy, ECE/NLL/Brier of the mean
confidence at the temperature, per-class PIW and MC variance, the
reliability bins, per-member vote accuracy and binomial 95 % CI
half-widths. The raw samples come back too, so temperature calibration
afterwards is a reweighting (``infer/calibrate.py``).

Randomness: per batch, the generator gives three streams, one each for the
corruptions, the attack's random start and the sampler's draws. The
variables of the JAX signatures are dropped: the modules hold their weights.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ladine_tpu_torch.attacks import make_attack
from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.graphs import GraphCache
from ladine_tpu_torch.infer.program import ServingProgram
from ladine_tpu_torch.infer.serve import _head_indices, _int8_forms
from ladine_tpu_torch.metrics.classification import (
    accuracy_topk,
    brier,
    ece,
    ensemble_confidence,
    majority_vote,
    nll,
    reliability_bins,
)
from ladine_tpu_torch.metrics.uncertainty import mc_variance_per_class, piw_per_class
from ladine_tpu_torch.models.conditional import ConditionalModel
from ladine_tpu_torch.models.guidance import SEViTGuidance
from ladine_tpu_torch.ops.corruptions import apply_corruptions
from ladine_tpu_torch.ops.diffusion import ddim_timesteps
from ladine_tpu_torch.ops.schedules import DiffusionSchedule

log = logging.getLogger("ladine_tpu_torch")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Corruption, attack and inference knobs (the reference's env-var
    surface and main.py flags); the JAX package's fields and defaults."""

    mc_trials: int = 20
    temperature: float = 0.1737
    noise_std: float = 0.0
    low_resolution: int = 1
    brightness: float = 0.0
    contrast: float = 1.0
    cover: Tuple[float, int] = (0.0, 0)
    crop: float = 0.0
    attack_name: Optional[str] = None
    attack_eps: float = 0.03
    ddim_steps: int = 0  # 0 = full ancestral chain (reference behavior)
    # eta=1 keeps the MC vote posterior under striding; unused when
    # ddim_steps == 0
    ddim_eta: float = 1.0
    skip_type: str = "uniform"  # strided timestep spacing: uniform | quad
    noise_prior: bool = False  # zero prior mean at T (reference --noise_prior)
    # indices into the guidance heads AND the stacked members (the reference
    # loads 6 members and runs 5); None = the first num_members heads with
    # all stacked members
    selected_members: Optional[Tuple[int, ...]] = None
    # the guidance head of each stacked member (conditioning only; the
    # member stack is used as-is); selected_members wins when both are set
    head_indices: Optional[Tuple[int, ...]] = None
    unroll: int = 1  # the JAX reverse scan's unroll; the port's chain is a loop
    use_int8: bool = False  # int8 lin2/lin3 through torch._int_mm
    use_int8_encode: bool = False  # int8 enc_lin1 and mapping-head linear1
    use_int8_pallas: bool = False  # int8 lin2/lin3 through the K4 kernel
    pallas_fuse_ends: bool = False  # with use_int8_pallas: the K5 kernels


def _select_members(model: ConditionalModel, idx: Tuple[int, ...]) -> ConditionalModel:
    """The stacked members ``idx`` of ``model``, as a model of their own
    (``model`` itself when ``idx`` is every member in order)."""
    if idx == tuple(range(model.members)):
        return model
    dtype = model.lin2.linear.weight.dtype
    sub = model.like(len(idx), "meta", dtype)
    state = model.state_dict()
    index = torch.tensor(idx, device=next(iter(state.values())).device)
    sub.load_state_dict({k: v.index_select(0, index) for k, v in state.items()}, assign=True)
    return sub


def _streams(generator: Optional[torch.Generator], device: torch.device, n: int = 3):
    """n generators on ``device`` seeded from ``generator`` (None: n times
    the device's default generator)."""
    if generator is None:
        return (None,) * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()
    return tuple(torch.Generator(device=device).manual_seed(int(s)) for s in seeds)


class EvalPipeline:
    """``pipeline(images, labels, generator) -> samples`` (M, mc_trials, B,
    C) float32 on the host: one batch of :func:`evaluate_ensemble`, as
    :meth:`prepare` (corruptions, attack, the sampler's draws) then
    :meth:`sample` (the program).

    ``draws`` may inject any of the batch's random draws: ``"corrupt"``
    (``apply_corruptions``' ``draws``), ``"attack"`` (the attack's start
    point ``x_init``) and ``"noise"`` (the sampler's, (n_draws, M,
    mc_trials, B, C)). ``seconds``, a dict, receives the seconds of each stage
    (``corrupt``, ``attack``, ``sample``; the card synchronized at each end).
    """

    def __init__(self, guidance: SEViTGuidance, model: ConditionalModel, sched: DiffusionSchedule,
                 cfg: EvalConfig, device):
        self.cfg, self.device = cfg, device
        self.guidance = guidance.to(device)
        model = model.to(device)
        sched = sched.to(device)
        if cfg.selected_members is not None:
            needed = tuple(int(i) for i in cfg.selected_members)
            model = _select_members(model, needed)
        elif cfg.head_indices is not None:
            needed = tuple(int(i) for i in cfg.head_indices)
        else:
            needed = tuple(range(guidance.num_members))
        idx = _head_indices(needed, model.members, guidance.num_members + 1)
        tau = (ddim_timesteps(sched.num_timesteps, cfg.ddim_steps, cfg.skip_type).tolist()
               if cfg.ddim_steps else None)
        qmember, qenc, qheads = _int8_forms(guidance, model, idx, guidance.num_members, cfg.use_int8,
                                            cfg.use_int8_pallas, cfg.use_int8_encode, model.arch)
        self.program = ServingProgram(
            guidance, model, sched, idx, temperature=cfg.temperature, mc_trials=cfg.mc_trials, tau=tau,
            eta=cfg.ddim_eta, noise_prior=cfg.noise_prior,
            use_int8_eps=cfg.use_int8 and not cfg.use_int8_pallas,
            use_int8_pallas=cfg.use_int8_pallas, pallas_fuse_ends=cfg.pallas_fuse_ends,
            qmember=qmember, qenc=qenc, qheads=qheads,
        )
        self.graphs = (GraphCache(lambda x, z: (self.program.samples(x, z),), device)
                       if device.type == "cuda" else None)
        self.attack = (make_attack(cfg.attack_name, cfg.attack_eps, self.guidance.vit_logits)
                       if cfg.attack_name else None)

    def _mark(self, seconds, name=None, t0=0.0) -> float:
        """Now, on the host clock (after the card's work when timing); with
        ``name``, the seconds since ``t0`` go into ``seconds[name]``."""
        if seconds is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if seconds is not None and name is not None:
            seconds[name] = now - t0
        return now

    def prepare(self, images, labels, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Any]] = None,
                seconds: Optional[Dict[str, float]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's corrupted (and attacked) images on the device and the
        sampler's draws: the inputs of :meth:`sample`."""
        cfg, dev = self.cfg, self.device
        draws = draws or {}
        g_corrupt, g_attack, g_sample = _streams(generator, dev)
        t0 = self._mark(seconds)
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(dev)
        y = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(dev)
        with torch.no_grad():
            x = apply_corruptions(x, g_corrupt, noise_std=cfg.noise_std, low_resolution=cfg.low_resolution,
                                  brightness=cfg.brightness, contrast=cfg.contrast, cover=cfg.cover,
                                  crop=cfg.crop, draws=draws.get("corrupt"))
        t0 = self._mark(seconds, "corrupt", t0)
        if self.attack is not None:
            x, _ = self.attack(x, y, g_attack, draws.get("attack"))
        self._mark(seconds, "attack", t0)
        noise = draws.get("noise")
        shape = self.program.noise_shape(x.shape[0])
        if noise is None:
            noise = torch.randn(shape, generator=g_sample, device=dev, dtype=torch.float32)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise must have shape {shape}; got {tuple(noise.shape)}")
        return x.detach().contiguous(), noise.to(dev, torch.float32)

    @torch.inference_mode()
    def sample(self, images: torch.Tensor, noise: torch.Tensor, eager: bool = False,
               seconds: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """The program's samples on the host: through the CUDA graph of the
        batch shape on the card (``eager=False``), else eagerly."""
        t0 = self._mark(seconds)
        if self.graphs is not None and not eager:
            (samples,) = self.graphs(images, noise)
        else:
            samples = self.program.samples(images, noise).cpu()
        self._mark(seconds, "sample", t0)
        return samples.float()

    def __call__(self, images, labels, generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, Any]] = None,
                 seconds: Optional[Dict[str, float]] = None) -> torch.Tensor:
        x, noise = self.prepare(images, labels, generator, draws, seconds)
        return self.sample(x, noise, seconds=seconds)


def make_eval_pipeline(guidance: SEViTGuidance, model: ConditionalModel, sched: DiffusionSchedule,
                       cfg: EvalConfig, mesh=None, device="cuda") -> EvalPipeline:
    """The per-batch evaluation function (:class:`EvalPipeline`) on
    ``device``: the modules and the schedule move there, the int8 forms the
    config calls for are quantized once. ``mesh`` is not ported (ROADMAP
    slice E item 16, ``parallel/``)."""
    if mesh is not None:
        raise NotImplementedError("the port's evaluator runs on one device: mesh= waits for "
                                  "ROADMAP slice E item 16 (parallel/)")
    return EvalPipeline(guidance, model, sched, cfg, resolve_device(device))


def evaluate_ensemble(
    guidance: SEViTGuidance,
    model: ConditionalModel,
    sched: DiffusionSchedule,
    batches: Iterable[Tuple[Any, Any]],
    cfg: EvalConfig,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    device="cuda",
    seconds: Optional[Dict[str, Any]] = None,
    pipeline: Optional[EvalPipeline] = None,
) -> Dict[str, Any]:
    """Run the robust-evaluation loop over ``(images, labels)`` batches
    (NHWC float32 in [0, 1], int labels; the last may be ragged) and return
    :func:`compute_report` of the member-major (S, N, C) samples.

    ``generator`` (default: a CPU generator seeded 0) gives each batch its
    three streams. ``seconds``, a dict, receives ``"batches"`` (each batch's
    stage seconds) and ``"report"``. ``pipeline``: a
    :func:`make_eval_pipeline` of these modules and ``cfg`` to reuse, with
    its CUDA graphs; else one is made."""
    if pipeline is None:
        pipeline = make_eval_pipeline(guidance, model, sched, cfg, mesh=mesh, device=device)
    elif pipeline.cfg != cfg:
        raise ValueError("the pipeline was made for another EvalConfig")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    all_samples, all_labels, stages = [], [], []
    m = None
    total = 0
    for i, (images, labels) in enumerate(batches):
        stage = {} if seconds is not None else None
        samples = pipeline(images, labels, generator, seconds=stage)
        m, k, b, c = samples.shape
        all_samples.append(samples.reshape(m * k, b, c).numpy())
        all_labels.append(np.asarray(labels))
        stages.append(stage)
        # a heartbeat per batch, with the running total (tail batches are ragged)
        total += b
        log.info("eval batch %d done (%d instances)", i, total)
    t0 = time.perf_counter()
    report = compute_report(np.concatenate(all_samples, axis=1), np.concatenate(all_labels),
                            cfg.temperature, num_members=m)
    if seconds is not None:
        seconds["batches"], seconds["report"] = stages, time.perf_counter() - t0
    return report


def compute_report(samples, labels, temperature: float, num_members: Optional[int] = None) -> Dict[str, Any]:
    """The reference's aggregate metric block over cached samples (S, N, C),
    plus the reliability-diagram bins and, when ``num_members`` divides S
    (samples ordered member-major), each member's vote accuracy."""
    samples = np.asarray(samples)
    labels = np.asarray(labels)
    s = torch.as_tensor(samples, dtype=torch.float32)
    y = torch.as_tensor(labels, dtype=torch.int64)
    mv = majority_vote(s)
    conf = ensemble_confidence(s, temperature)
    (top1,) = accuracy_topk(conf, y, (1,))
    mv_acc = float((mv == y).float().mean() * 100.0)
    piw_c, piw_i = piw_per_class(s, mv, y)
    var_c, var_i = mc_variance_per_class(s, mv, y)
    count, bin_conf, bin_acc = reliability_bins(conf, y)
    extra: Dict[str, Any] = {
        "reliability": {
            "count": count.numpy().tolist(),
            "confidence": bin_conf.numpy().round(4).tolist(),
            "accuracy": bin_acc.numpy().round(4).tolist(),
        }
    }
    if num_members and samples.shape[0] % num_members == 0:
        per_member = s.reshape(num_members, -1, *s.shape[1:])
        extra["per_member_mv_accuracy"] = [
            round(float((majority_vote(per_member[i]) == y).float().mean() * 100.0), 2)
            for i in range(num_members)]
    n = int(labels.shape[0])

    def ci95(acc_pct: float) -> float:
        """Binomial 95 % CI half-width, in percentage points."""
        p = min(max(acc_pct / 100.0, 0.0), 1.0)
        return round(196.0 * float(np.sqrt(p * (1.0 - p) / max(n, 1))), 2)

    return {
        **extra,
        "num_samples": int(samples.shape[0]),
        "num_instances": n,
        "majority_vote_accuracy": mv_acc,
        "majority_vote_accuracy_ci95_pp": ci95(mv_acc),
        "mean_confidence_accuracy_ci95_pp": ci95(float(top1)),
        "mean_confidence_accuracy": float(top1),
        "ece": float(ece(conf, y)),
        "nll": float(nll(conf, y, eps=1e-12)),
        "brier": float(brier(conf, y)),
        "piw_correct": piw_c.numpy().tolist(),
        "piw_incorrect": piw_i.numpy().tolist(),
        "mc_variance_correct": var_c.numpy().tolist(),
        "mc_variance_incorrect": var_i.numpy().tolist(),
        "temperature": float(temperature),
        "samples": samples,
        "labels": labels,
    }
