"""Serving API: the nested-ensemble predictor.

Counterpart of ``ladine_tpu/infer/serve.py::Predictor``:

    predictor = Predictor.from_preset("parity", guidance=g, model=m, sched=s)
    out = predictor.predict(images)          # NHWC float32 [0, 1]
    out["probs"], out["majority_vote"], out["piw"], out["mc_variance"]

One ``predict`` runs the guidance heads, the member encoders and the
reverse chain of every member x MC trial x image on the card, then
aggregates the samples into the four numpy outputs. The int8 presets and
``save``/``load``/``export_serving`` are not ported yet (ROADMAP slice B).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional

import numpy as np
import torch

from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.metrics.classification import convert_to_prob, majority_vote
from ladine_tpu_torch.models.conditional import ConditionalModel
from ladine_tpu_torch.models.guidance import SEViTGuidance
from ladine_tpu_torch.ops.diffusion import ddim_timesteps
from ladine_tpu_torch.ops.schedules import DiffusionSchedule

# The JAX package's named operating points. Only "parity" (the full
# ancestral chain in float) runs in the port so far; the others quantize the
# eps matmuls to int8 (ROADMAP slice B).
PRESETS = {
    "parity": dict(ddim_steps=0, use_int8=False, use_int8_encode=False),
    "serving": dict(ddim_steps=50, ddim_eta=1.0, skip_type="uniform",
                    use_int8=True, use_int8_encode=False),
    "fast": dict(ddim_steps=10, ddim_eta=1.0, skip_type="uniform",
                 use_int8=True, use_int8_encode=True),
}


@dataclasses.dataclass
class Predictor:
    guidance: SEViTGuidance
    model: ConditionalModel
    sched: DiffusionSchedule
    temperature: float = 0.1737
    mc_trials: int = 20
    ddim_steps: int = 50  # strided sampler steps (0 = full ancestral chain)
    ddim_eta: float = 1.0
    skip_type: str = "uniform"  # strided timestep spacing: uniform | quad
    noise_prior: bool = False  # zero prior mean at T (reference --noise_prior)
    use_int8: bool = False
    use_int8_encode: bool = False
    seed: int = 0
    # which guidance heads condition the stacked members; None = heads
    # 0..n_stacked-1
    head_indices: Optional[tuple] = None
    device: Any = "cuda"

    def __post_init__(self):
        if self.use_int8 or self.use_int8_encode:
            raise NotImplementedError(
                "the int8 eps/encoder paths (use_int8, use_int8_encode; presets "
                "'serving' and 'fast') are not ported yet: ROADMAP slice B"
            )
        self.device = resolve_device(self.device)
        self.guidance.to(self.device)
        self.model.to(self.device)
        self.sched = self.sched.to(self.device)
        self._tau = (
            ddim_timesteps(self.sched.num_timesteps, self.ddim_steps, self.skip_type).tolist()
            if self.ddim_steps
            else None
        )
        n_stacked = self.model.members
        idx = tuple(
            int(i) for i in (
                self.head_indices if self.head_indices is not None else range(n_stacked)
            )
        )
        if len(idx) != n_stacked:
            raise ValueError(
                f"head_indices {self.head_indices} must match the {n_stacked} stacked members"
            )
        n_heads = self.guidance.num_members + 1
        if any(not 0 <= i < n_heads for i in idx):
            raise ValueError(
                f"head_indices {self.head_indices} out of range: the guidance "
                f"has {n_heads} heads (0..{n_heads - 1})"
            )
        self._idx = idx
        # itertools.count is atomic under the GIL: concurrent predict() calls
        # in a threaded server never share a seed
        self._counter = itertools.count()

    @classmethod
    def from_preset(cls, preset: str, **kwargs) -> "Predictor":
        """A predictor at a named operating point; explicit ``kwargs`` win."""
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
        return cls(**{**PRESETS[preset], **kwargs})

    @torch.inference_mode()
    def predict(
        self,
        images,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, np.ndarray]:
        """images: (B, H, W, 3) float32 in [0, 1]. Returns numpy outputs.

        Without a ``generator``, each call seeds a fresh one from ``seed``
        and a call counter. ``noise`` injects the sampler's draws (see
        ``infer.engine.nested_ensemble_sample``)."""
        s = self.guidance.img_size
        if images.ndim != 4 or tuple(images.shape[1:]) != (s, s, 3):
            raise ValueError(
                f"predict expects images of shape (B, {s}, {s}, 3); got {tuple(images.shape)}"
            )
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.seed * 2**32 + next(self._counter))
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        heads = self.guidance.heads_subset(x, self._idx)
        y0_hat = torch.softmax(heads.float(), dim=-1)
        x_flat = x.reshape(x.shape[0], -1)  # NHWC, channel-last
        samples = nested_ensemble_sample(
            self.model, x_flat, y0_hat, self.sched, mc_trials=self.mc_trials,
            tau=self._tau, eta=self.ddim_eta, noise_prior=self.noise_prior,
            generator=generator, noise=noise,
        )
        m, k, b, c = samples.shape
        flat = samples.reshape(m * k, b, c)
        probs = convert_to_prob(flat, self.temperature).mean(dim=0)
        mv = majority_vote(flat)
        q = torch.tensor([0.025, 0.975], dtype=flat.dtype, device=flat.device)
        lo, hi = torch.quantile(flat, q, dim=0)  # linear interpolation, as jnp
        piw = (hi - lo).gather(1, mv[:, None])[:, 0]
        var = flat.var(dim=0, correction=1).gather(1, mv[:, None])[:, 0]
        return {
            "probs": probs.cpu().numpy(),
            "majority_vote": mv.cpu().numpy(),
            "piw": piw.cpu().numpy(),
            "mc_variance": var.cpu().numpy(),
        }
