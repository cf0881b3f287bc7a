"""The serving program: one ``Predictor.predict`` as a function of tensors.

Counterpart of the JAX package's ``_raw`` (``ladine_tpu/infer/serve.py``):
images and the sampler's noise in, the four outputs out. It reads only
tensors that the module holds, its *run weights*: the float weights of the
guidance and of the stacked members, the resident int8 forms, the schedule
and the step coefficients of the sampler. Nothing in it copies from the
host or waits on the device, so on the card it is captured as one CUDA
graph per batch shape (``infer/graphs.py``), and ``torch.export`` takes it
with the run weights as inputs (``Predictor.export_serving``).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.kernels.int8 import int8_mapping_heads
from ladine_tpu_torch.metrics.classification import convert_to_prob, majority_vote
from ladine_tpu_torch.ops.diffusion import DDIMCoeffs, PSampleCoeffs, ancestral_table, ddim_table
from ladine_tpu_torch.ops.schedules import DiffusionSchedule


class ServingProgram(nn.Module):
    """``forward(images, noise) -> (probs, majority_vote, piw, mc_variance)``,
    the aggregate of ``samples(images, noise)``.

    images: (B, H, W, 3) float32 on the program's device; noise: the
    sampler's draws, (n_draws, M, mc_trials, B, y_dim) float32 (see
    ``infer.engine.nested_ensemble_sample``). ``qmember``, ``qenc`` and
    ``qheads`` are the resident int8 forms (``kernels/int8.py``), or None;
    they are held as buffers, as are the schedule and the step table. The
    encoder runs int8 where ``qenc`` is given. ``rows``: the members of the
    heads ``idx`` that ``model`` holds (a rank's rows on a mesh,
    ``parallel/``): every head is computed, as on one device, and these
    condition the chain."""

    def __init__(self, guidance, model, sched: DiffusionSchedule, idx: Sequence[int], *,
                 temperature: float, mc_trials: int, tau: Optional[Sequence[int]], eta: float,
                 noise_prior: bool, use_int8_eps: bool, use_int8_pallas: bool,
                 pallas_fuse_ends: bool, qmember=None, qenc=None, qheads=None, rows: slice = slice(None)):
        super().__init__()
        self.guidance, self.model = guidance, model
        self.idx, self.tau, self.rows = tuple(idx), tau, rows
        self.temperature, self.mc_trials, self.eta, self.noise_prior = temperature, mc_trials, eta, noise_prior
        self.use_int8_eps, self.use_int8_encode = use_int8_eps, qenc is not None
        self.use_int8_pallas, self.pallas_fuse_ends = use_int8_pallas, pallas_fuse_ends
        for name, t in zip(DiffusionSchedule._fields, sched):
            self.register_buffer(f"sched_{name}", t)
        table = ancestral_table(sched) if tau is None else ddim_table(sched, tau, eta)
        for name, t in zip(table._fields, table):
            self.register_buffer(f"step_{name}", t)
        self.int8_layers = tuple(qmember or ())
        for name, (w_q, scale, colsum) in (qmember or {}).items():
            self.register_buffer(f"q_{name}_w", w_q)
            self.register_buffer(f"q_{name}_scale", scale)
            self.register_buffer(f"q_{name}_colsum", colsum)
        if qenc is not None:
            self.register_buffer("q_enc_w", qenc[0])
            self.register_buffer("q_enc_scale", qenc[1])
        self.heads = tuple(sorted(qheads or ()))
        for i in self.heads:
            self.register_buffer(f"q_head{i}_w", qheads[i][0])
            self.register_buffer(f"q_head{i}_scale", qheads[i][1])

    def noise_shape(self, batch: int) -> Tuple[int, ...]:
        """The shape of the draws of one request of ``batch`` images."""
        n_draws = self.sched_betas.shape[0] if self.tau is None else len(self.tau)
        return (n_draws, self.model.members, self.mc_trials, batch, self.model.y_dim)

    def run_weights(self) -> Dict[str, torch.Tensor]:
        """Every tensor the program may read, by name (its parameters and
        buffers), without the float weights that an int8 form replaces:
        lin2 and lin3 under the int8 eps, enc_lin1 under the int8 encoder,
        and the mapping heads' linear1 under int8 heads. Unused parts of the
        guidance (ViT blocks past the deepest tap) stay in, as they stay in
        the JAX package's run trees."""
        replaced = {f"model.{n}.linear.weight" for n in self.int8_layers}
        if self.use_int8_encode:
            replaced.add("model.enc_lin1.weight")
        replaced |= {f"guidance.mlps.{i}.layers.0.weight" for i in self.heads}
        return {k: v.detach() for k, v in itertools.chain(self.named_parameters(), self.named_buffers())
                if k not in replaced}

    def samples(self, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The chain's raw samples, (M, mc_trials, B, y_dim): the guidance
        heads, their softmax, then every member's reverse chain. ``forward``
        aggregates them; the evaluator (``infer/evaluator.py``) keeps them."""
        g = self.guidance
        if self.heads:
            taps = g.taps_subset(images, self.idx)
            qheads = {i: (getattr(self, f"q_head{i}_w"), getattr(self, f"q_head{i}_scale"))
                      for i in self.heads}
            heads = int8_mapping_heads(g, taps, self.idx, qheads)
        else:
            heads = g.heads_subset(images, self.idx)
        y0_hat = torch.softmax(heads.float(), dim=-1)[self.rows]
        sched = DiffusionSchedule(*(getattr(self, f"sched_{n}") for n in DiffusionSchedule._fields))
        fields = PSampleCoeffs._fields if self.tau is None else DDIMCoeffs._fields
        table = (PSampleCoeffs if self.tau is None else DDIMCoeffs)(
            *(getattr(self, f"step_{n}") for n in fields))
        qmember = {n: tuple(getattr(self, f"q_{n}_{p}") for p in ("w", "scale", "colsum"))
                   for n in self.int8_layers} or None
        qenc = (self.q_enc_w, self.q_enc_scale) if self.use_int8_encode else None
        return nested_ensemble_sample(
            self.model, images.reshape(images.shape[0], -1), y0_hat, sched,
            mc_trials=self.mc_trials, tau=self.tau, eta=self.eta, noise_prior=self.noise_prior,
            noise=noise, use_int8_eps=self.use_int8_eps, use_int8_encode=self.use_int8_encode,
            use_int8_pallas=self.use_int8_pallas, pallas_fuse_ends=self.pallas_fuse_ends,
            qmember=qmember, qenc=qenc, sampler_table=table,
        )

    def forward(self, images: torch.Tensor, noise: torch.Tensor):
        return aggregate(self.samples(images, noise), self.temperature)


def aggregate(samples: torch.Tensor, temperature: float):
    """(M, K, B, C) samples -> (probs, majority_vote, piw, mc_variance), each
    batch-leading: the mean tempered probability, the vote, and the 95 %
    interval width and variance of the voted class."""
    m, k, b, c = samples.shape
    flat = samples.reshape(m * k, b, c)
    probs = convert_to_prob(flat, temperature).mean(dim=0)
    mv = majority_vote(flat)
    # linear interpolation, as jnp.quantile
    lo, hi = torch.quantile(flat, 0.025, dim=0), torch.quantile(flat, 0.975, dim=0)
    piw = (hi - lo).gather(1, mv[:, None])[:, 0]
    var = flat.var(dim=0, correction=1).gather(1, mv[:, None])[:, 0]
    return probs, mv, piw, var


class WeightsAsInputs(nn.Module):
    """A program with its run weights as inputs: ``forward(weights, images,
    noise)``, ``weights`` as :meth:`ServingProgram.run_weights` gives them.
    ``torch.export`` takes this, so the exported program holds no weight of
    its own."""

    def __init__(self, program: ServingProgram):
        super().__init__()
        object.__setattr__(self, "program", program)  # not a submodule: no parameters here

    def forward(self, weights: Dict[str, torch.Tensor], images: torch.Tensor, noise: torch.Tensor):
        return torch.func.functional_call(self.program, weights, (images, noise))
