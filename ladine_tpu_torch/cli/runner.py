"""Experiment runner: wires Config -> models -> train/eval/calibrate.

Counterpart of ``ladine_tpu/cli/runner.py``: a thin orchestration layer over
the library. It owns model construction, checkpoint IO and the host batch
loop, and nothing numerical: the train steps, optimizers, EMA, sampler and
evaluator are ``train/``'s and ``infer/``'s.

The JAX runner passes variable trees to pure functions; here the weights
are state dicts (tensors by ``state_dict`` name) and the runner builds a
module of the compute dtype around them when it runs one
(:meth:`Runner.guidance_module`, :meth:`Runner.members_module`). The
guidance's weights are ``{"params": <SEViTGuidance state dict>}``
(``utils/assemble.py``); the members' are one ``ConditionalModel`` state
dict with the leading member axis, running statistics included. Random
draws come from ``torch.Generator``s seeded from the run's seed.

Everything runs on ``device`` (default ``"cuda"``; without a card it raises
unless the caller passes ``"cpu"``). Under an initialized process group of
more than one rank (``cli.main`` initializes one under ``torchrun``) the
member training and the evaluation run on the JAX runner's
('member', 'data') mesh (``parallel/``; ``model.fsdp`` shards the train
state's large leaves over 'data' too), and rank 0 alone writes files and
logs while the others wait where they would read them.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ladine_tpu_torch.config import Config
from ladine_tpu_torch.data import CALIBRATED_TEMPERATURE, base_dataset, open_dataset
from ladine_tpu_torch.device import resolve_device
from ladine_tpu_torch.infer.calibrate import calibration_objective, temperature_search
from ladine_tpu_torch.infer.engine import nested_ensemble_sample
from ladine_tpu_torch.infer.evaluator import EvalConfig, compute_report, evaluate_ensemble
from ladine_tpu_torch.metrics.classification import majority_vote
from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule, ddim_timesteps, one_hot_and_prototype
from ladine_tpu_torch.parallel import (
    describe_mesh,
    factor_mesh,
    fsdp_plan,
    gather_data,
    gather_tree,
    group_devices_by_slice,
    make_mesh,
    make_multislice_mesh,
)
from ladine_tpu_torch.parallel.mesh import in_mesh, is_writer, mesh_shape
from ladine_tpu_torch.train import (
    MemberTrainState,
    create_member_states,
    ema_params_from_ckpt,
    ema_read,
    make_full_train_step,
    make_joint_train_step,
    make_multi_member_step,
    make_optimizer,
    warmup_cosine,
)
from ladine_tpu_torch.train import functional as Fn
from ladine_tpu_torch.utils import (
    ScalarLogger,
    assemble_guidance,
    best_checkpoint_name,
    load_checkpoint,
    load_checkpoint_meta,
    load_train_state,
    save_checkpoint,
    save_train_state,
    setup_logging,
    validate_guidance_tree,
)

Tensors = Dict[str, torch.Tensor]


def derive_seed(*parts: int) -> int:
    """A 63-bit seed mixed from integers (numpy's SeedSequence): the
    generator of a resumed run, of each validation, of each test."""
    return int(np.random.SeedSequence([int(p) & (2**63 - 1) for p in parts]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def lr_schedule(c: Config, epochs: int, steps_per_epoch: int):
    """The members' learning rate: ``warmup_cosine`` with the warm-up
    clamped to a tenth of the run (the reference's 40 warm-up epochs assume
    1000 epochs), or the constant ``optim.lr``."""
    warmup = min(c.training.warmup_epochs, max(1, epochs // 10))
    if not c.optim.lr_schedule:
        return c.optim.lr
    return warmup_cosine(c.optim.lr, warmup, epochs, steps_per_epoch, c.optim.min_lr)


class Runner:
    def __init__(self, config: Config, log_dir: str = "./logs", demo: bool = False, device="cuda"):
        self.config = config
        self.log_dir = log_dir
        self.demo = demo
        self.device = resolve_device(device)
        # rank 0 of a process group writes files and logs, or a lone process
        self.writer = is_writer()
        self.logger = setup_logging(log_dir if self.writer else None)
        self.scalars = ScalarLogger(log_dir if self.writer else None)
        self._meshes: Dict[int, Any] = {}
        c = config
        if demo:
            # tiny structurally-real models + synthetic data: the runnable
            # smoke path
            self.img, self.patch, self.embed, self.heads_n, self.depth = 16, 8, 16, 2, c.diffusion.num_members
            self.feat = self.hidden = 16
            self.mlp_dims = (16, 8, 8)
        else:
            m = c.model
            self.img, self.patch, self.embed = m.image_size, m.patch_size, m.embed_dim
            self.heads_n, self.depth = m.num_heads, m.vit_depth
            self.feat, self.hidden = m.feature_dim, m.hidden_dim
            self.mlp_dims = tuple(m.mlp_hidden_dims)
        self.dtype = torch.bfloat16 if c.model.dtype == "bfloat16" else torch.float32
        # templates of the compute dtype, with no storage: their names,
        # shapes and dtypes; the trainers run them on float32 masters
        self.guidance = self._guidance_template()
        self.cond = self._cond_template(c.diffusion.num_members)
        self.sched = DiffusionSchedule.create(c.diffusion.beta_schedule, c.diffusion.timesteps,
                                              c.diffusion.beta_start, c.diffusion.beta_end, device=self.device)
        try:
            self.temperature = CALIBRATED_TEMPERATURE[base_dataset(c.data.dataset)]
        except (ValueError, KeyError):
            self.temperature = 0.2555

    def _guidance_template(self, device="meta", dtype=None) -> SEViTGuidance:
        c = self.config
        return SEViTGuidance(num_classes=c.data.num_classes, num_members=c.diffusion.num_members,
                             vit_depth=self.depth, img_size=self.img, patch_size=self.patch,
                             embed_dim=self.embed, num_heads=self.heads_n, mlp_hidden_dims=self.mlp_dims,
                             device=device, dtype=dtype or self.dtype)

    def _cond_template(self, members: int, device="meta", dtype=None) -> ConditionalModel:
        c = self.config
        return ConditionalModel(members, self.img * self.img * 3, self.feat, self.hidden, c.data.num_classes,
                                c.diffusion.timesteps + 1, guidance=c.diffusion.include_guidance,
                                device=device, dtype=dtype or self.dtype)

    # ----------------------------------------------------------- data

    def _demo_batches(self, n_batches=3, batch=8, seed=0):
        """Separable synthetic images (class-dependent brightness + noise),
        so the demo can learn: the JAX runner's, numpy for numpy."""
        rng = np.random.default_rng(seed)
        nc = self.config.data.num_classes
        for _ in range(n_batches):
            labels = rng.integers(0, nc, batch)
            images = (rng.random((batch, self.img, self.img, 3)) * 0.2
                      + labels[:, None, None, None] * (0.6 / max(nc - 1, 1)))
            yield images.astype(np.float32), labels

    def _dataset(self, split: str):
        """The split's dataset, opened once a run (data/router.py)."""
        if not hasattr(self, "_ds_cache"):
            self._ds_cache = {}
        if split not in self._ds_cache:
            c = self.config
            self._ds_cache[split] = open_dataset(c.data.dataset, c.data.dataroot, split,
                                                 preprocess=c.data.preprocess, image_size=(self.img, self.img))
        return self._ds_cache[split]

    def batches(self, split: str, batch_size: int, drop_last: bool = False, shuffle=False, seed=0,
                with_indices: bool = False):
        if self.demo:
            gen = self._demo_batches(batch=batch_size)
            if not with_indices:
                return gen

            def _demo_with_idx():
                # the demo batches are one fixed sequence: a sample's
                # identity is its place in it
                start = 0
                for images, labels in gen:
                    yield images, labels, np.arange(start, start + len(labels))
                    start += len(labels)

            return _demo_with_idx()
        return self._dataset(split).batches(batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                                            with_indices=with_indices)

    def num_batches(self, split: str, batch_size: int, drop_last: bool = False) -> int:
        """The batch count from the file listing, without decoding."""
        if self.demo:
            return 3
        n = len(self._dataset(split))
        return n // batch_size if drop_last else -(-n // batch_size)

    def _tensor_batch(self, images, labels):
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(self.device)
        return x, torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(self.device)

    # --------------------------------------------------- weights <-> modules

    def to_eval_vars(self, tensors: Optional[Tensors], template: torch.nn.Module,
                     eval_cast: bool = False) -> Optional[Tensors]:
        """A state dict on the runner's device; with ``eval_cast`` each
        tensor in the dtype of ``template``'s tensor of its name (the
        compute dtype's layout: bf16 weights, float32 BatchNorm and gates),
        which also upcasts a bf16-stored light checkpoint under a float32
        config."""
        if tensors is None:
            return None
        if eval_cast:
            tensors = Fn.cast_like(template, tensors)
        return {k: v.to(self.device) for k, v in tensors.items()}

    def _load_into(self, module: torch.nn.Module, tensors: Tensors) -> torch.nn.Module:
        own = dict(module.state_dict())
        module.load_state_dict({k: v.to(self.device, own[k].dtype) for k, v in tensors.items()},
                               assign=True)
        return module

    def guidance_module(self, gvars: Dict[str, Tensors]) -> SEViTGuidance:
        """A ``SEViTGuidance`` of the compute dtype on the device holding
        ``gvars["params"]`` (shared where dtype and device already agree)."""
        return self._load_into(self._guidance_template(), gvars["params"])

    def members_module(self, stacked: Tensors) -> ConditionalModel:
        """A ``ConditionalModel`` of the compute dtype on the device holding
        the stacked members' state dict (their count from its leading axis)."""
        m = next(iter(stacked.values())).shape[0]
        return self._load_into(self._cond_template(m), stacked)

    # ------------------------------------------------------- guidance io

    def init_guidance(self, generator: Optional[torch.Generator] = None, ckpt_path: Optional[str] = None,
                      vit_ckpt: Optional[str] = None, mlp_dir: Optional[str] = None,
                      eval_cast: bool = False, host_only: bool = False) -> Dict[str, Tensors]:
        """Guidance weights ``{"params": state dict}``: a random float32 init
        from ``generator`` (default: seeded 0), a full ``--guidance_ckpt``, or the stage-1
        checkpoints assembled in place. Loads are checked against the
        model's names and shapes. ``host_only``: on the CPU as loaded;
        ``eval_cast``: in the compute dtype's layout on the device; else
        float32 on the device (the masters the guidance trainers update)."""
        if not (ckpt_path or vit_ckpt or mlp_dir):
            dev = torch.device("cpu") if host_only else self.device
            g = self._guidance_template(device=dev, dtype=torch.float32)
            init_random_(g, generator or torch.Generator(device=dev).manual_seed(0))
            tree = {"params": dict(g.state_dict())}
        else:
            template = self._guidance_template(dtype=torch.float32).state_dict()
            if ckpt_path:
                if not os.path.exists(ckpt_path):
                    raise FileNotFoundError(f"--guidance_ckpt {ckpt_path} does not exist")
                tree, _ = load_checkpoint(ckpt_path)
                self.logger.info(f"loaded guidance from {ckpt_path}")
            else:
                if not (vit_ckpt and mlp_dir):
                    raise ValueError("--vit_ckpt and --mlp_ckpt_dir must be given together")
                tree = assemble_guidance(vit_ckpt, mlp_dir=mlp_dir, num_members=self.config.diffusion.num_members)
                self.logger.info(f"assembled guidance from stage-1 ckpts {vit_ckpt} + {mlp_dir}")
            tree = validate_guidance_tree(tree, template, cast=False)
        if host_only:
            return tree
        if eval_cast:
            return {"params": self.to_eval_vars(tree["params"], self.guidance, eval_cast=True)}
        return {"params": {k: v.to(self.device, torch.float32) for k, v in tree["params"].items()}}

    def _yhat_cache_path(self, guidance_ckpt, vit_ckpt, mlp_dir) -> str:
        """Where the shared y0_hat cache lives. Its signature covers what the
        cached predictions depend on: the stage-1 artifact paths and their
        contents' mtimes, the dataset root, name and preprocess, the image
        size, both split lengths and num_members."""
        import hashlib

        def content_mtime(p):
            if os.path.isdir(p):
                mts = [os.path.getmtime(os.path.join(r, f)) for r, _dirs, files in os.walk(p) for f in files]
                return [len(mts), max(mts, default=0.0)]
            return [1, os.path.getmtime(p)]

        c = self.config
        sig_src = json.dumps({
            "g": guidance_ckpt, "v": vit_ckpt, "m": mlp_dir,
            "mt": [content_mtime(p) for p in (guidance_ckpt, vit_ckpt, mlp_dir) if p and os.path.exists(p)],
            "dataroot": os.path.abspath(c.data.dataroot) if c.data.dataroot else None,
            "dataset": c.data.dataset, "preprocess": c.data.preprocess,
            "img": self.img, "num_members": c.diffusion.num_members,
            "n_train": len(self._dataset("train")), "n_valid": len(self._dataset("valid")),
        }, sort_keys=True)
        sig = hashlib.sha1(sig_src.encode()).hexdigest()[:12]
        return os.path.join(os.path.dirname(os.path.abspath(self.log_dir)), f"yhat_cache_{sig}.npz")

    @torch.no_grad()
    def precompute_yhat(self, gmod: SEViTGuidance, split: str, head_indices, batch_size: int) -> np.ndarray:
        """The frozen guidance's softmax (float32) for every sample of a
        split, by dataset position: (N, K_sel, C). The guidance is frozen
        in member training, so this is a constant per image."""
        idx = tuple(int(i) for i in head_indices)
        pairs = []
        for images, _labels, bidx in self.batches(split, batch_size, with_indices=True):
            x, _ = self._tensor_batch(images, _labels)
            yh = torch.softmax(gmod.heads_subset(x, idx).float(), dim=-1).cpu().numpy()  # (K_sel, B, C)
            pairs.append((np.asarray(bidx), np.transpose(yh, (1, 0, 2))))
        n = max(int(b.max()) for b, _ in pairs) + 1
        out = np.zeros((n,) + pairs[0][1].shape[1:], np.float32)
        for bidx, yh in pairs:
            out[bidx] = yh
        self.logger.info(f"precomputed frozen-guidance y0_hat for '{split}': {out.shape}")
        return out

    # -------------------------------------------------------- members io

    def init_members(self, generator: Optional[torch.Generator] = None, ckpt_paths: Optional[Sequence[str]] = None,
                     eval_cast: bool = False) -> Tensors:
        """The stacked members' state dict: from per-member variable
        checkpoints (each a ``ConditionalModel`` state dict with a leading
        member axis, checked against the model, stacked in order), or a
        random float32 init of ``diffusion.num_members`` members from
        ``generator`` (default: seeded 1)."""
        c = self.config
        if ckpt_paths:
            parts = []
            for p in ckpt_paths:
                tree, _ = load_checkpoint(p)
                n = next(iter(tree.values())).shape[0]
                template = self._cond_template(n, dtype=torch.float32).state_dict()
                validate_guidance_tree({"params": tree}, template, cast=False, what=f"member checkpoint {p}")
                parts.append(self.to_eval_vars(tree, self._cond_template(n), eval_cast))
            self.logger.info(f"loaded {len(parts)} diffusion member checkpoints")
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        m = self._cond_template(c.diffusion.num_members, device=self.device, dtype=torch.float32)
        init_random_(m, generator or torch.Generator(device=self.device).manual_seed(1))
        return dict(m.state_dict())

    def load_members_from_train_ckpt(self, path: str, use_ema: bool = False, eval_cast: bool = False,
                                     resolve_guidance: bool = True):
        """Evaluation's loader of a training checkpoint (``diffu_all*`` /
        ``diffu{k}*``): (stacked member state dict, guidance weights or
        None, metadata). ``use_ema`` reads the debiased EMA instead of the
        raw parameters. A light checkpoint that references its stage-1
        guidance resolves it (absolute paths first, then relative to the
        checkpoint)."""
        meta = load_checkpoint_meta(path)
        if meta.get("kind") != "diffusion_members":
            raise ValueError(f"{path} is not a diffusion training checkpoint (kind={meta.get('kind')!r}); pass "
                             "per-member variable checkpoints as separate --diffusion_ckpt arguments instead")
        states, guidance, meta = load_train_state(path)
        st = states if isinstance(states, dict) else vars(states)
        params = ema_params_from_ckpt(st, meta) if use_ema else st["params"]
        n = st["step"].shape[0]
        variables = self.to_eval_vars({**params, **st["batch_stats"]}, self._cond_template(n), eval_cast)
        if guidance is None and resolve_guidance and meta.get("guidance_src"):
            src, rel = meta["guidance_src"], meta.get("guidance_src_rel") or {}

            def resolve(name):
                p = src.get(name)
                if p and os.path.exists(p):
                    return p
                r = rel.get(name)
                if r:
                    cand = os.path.normpath(os.path.join(path, r))
                    if os.path.exists(cand):
                        return cand
                if p or r:
                    raise FileNotFoundError(
                        f"light checkpoint {path} references its guidance {name} at {p!r} (relative: {r!r}) "
                        "but neither resolves on this machine: move the stage-1 artifacts alongside the "
                        "checkpoint, or pass --guidance_ckpt/--vit_ckpt explicitly")
                return None

            guidance = self.init_guidance(None, resolve("guidance_ckpt"), vit_ckpt=resolve("vit_ckpt"),
                                          mlp_dir=resolve("mlp_dir"), host_only=True)
        self.logger.info(f"loaded {n} trained members from {path}" + (" (EMA weights)" if use_ema else ""))
        return variables, guidance, meta

    def load_members_from_train_ckpts(self, paths: Sequence[str], use_ema: bool = False, eval_cast: bool = False):
        """Members stacked from one or several training checkpoints (the
        reference's per-member workflow); the guidance from the first.
        Returns (stacked, guidance, head_indices): the guidance head each
        stacked member trained against (``member_idx`` of the metadata), or
        None where a single-member checkpoint does not record it."""
        parts, gvars, head_indices = [], None, []
        for p in paths:
            variables, g, meta = self.load_members_from_train_ckpt(p, use_ema=use_ema, eval_cast=eval_cast,
                                                                   resolve_guidance=gvars is None)
            n_i = next(iter(variables.values())).shape[0]
            idx = meta.get("member_idx")
            if idx is None and n_i == 1 and len(paths) > 1:
                head_indices = None  # a legacy single-member checkpoint: its head is unknown
            if head_indices is not None:
                head_indices.extend([idx] if idx is not None else range(n_i))
            parts.append(variables)
            if gvars is None:
                gvars = g
        stacked = parts[0] if len(parts) == 1 else {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        n = next(iter(stacked.values())).shape[0]
        self.logger.info(f"stacked {n} members from {len(paths)} training ckpts"
                         + (f" (guidance heads {head_indices})" if head_indices else ""))
        return stacked, gvars, tuple(head_indices) if head_indices else None

    # ------------------------------------------------------------ train

    def train(self, seed: int = 0, guidance_ckpt: Optional[str] = None, epochs: Optional[int] = None,
              resume_from: Optional[str] = None, pretrain_guidance_steps: int = 0,
              member_idx: Optional[int] = None, joint_train: bool = False, eval_ema: bool = False,
              vit_ckpt: Optional[str] = None, mlp_dir: Optional[str] = None, precompute_yhat: bool = False,
              light_ckpt: bool = False) -> Dict[str, Any]:
        """Train all diffusion members together, or only ``member_idx`` (the
        reference's per-member run). ``resume_from`` restores the states,
        the guidance and the epoch from a full checkpoint. The draws come
        from a generator on the device seeded with ``seed`` (on resume, with
        the seed and the epoch)."""
        c = self.config
        dev = self.device
        epochs = epochs if epochs is not None else c.training.n_epochs
        if member_idx is not None and not 0 <= member_idx < c.diffusion.num_members:
            raise ValueError(f"member_idx {member_idx} out of range [0, {c.diffusion.num_members})")
        if precompute_yhat and joint_train:
            raise ValueError("--precompute_guidance assumes a FROZEN guidance; --joint_train updates it every step")
        head_indices = (member_idx,) if member_idx is not None else None
        n_train_members = 1 if member_idx is not None else c.diffusion.num_members
        random_guidance = self.demo and guidance_ckpt is None and vit_ckpt is None
        # a frozen guidance from stage-1 artifacts can be referenced by a
        # light checkpoint instead of copied into it
        guidance_untouched = not pretrain_guidance_steps and not joint_train and not random_guidance
        yhat_cache_path = None
        if precompute_yhat and guidance_untouched and not self.demo and (guidance_ckpt or vit_ckpt):
            yhat_cache_path = self._yhat_cache_path(guidance_ckpt, vit_ckpt, mlp_dir)
        yhat_cache_hit = bool(yhat_cache_path and os.path.exists(yhat_cache_path))
        skip_guidance_load = yhat_cache_hit and light_ckpt
        gen = torch.Generator(device=dev).manual_seed(seed)
        gmod = None
        if skip_guidance_load:
            gvars = None
            self.logger.info("y0_hat cache hit + light checkpoints: skipping the guidance load entirely")
        elif guidance_untouched:
            # frozen: float32 as loaded on the host (for checkpoints), the
            # compute dtype on the device
            gvars = self.init_guidance(None, guidance_ckpt, vit_ckpt=vit_ckpt, mlp_dir=mlp_dir, host_only=True)
            gmod = self.guidance_module(gvars)
        else:
            gvars = self.init_guidance(None, guidance_ckpt, vit_ckpt=vit_ckpt, mlp_dir=mlp_dir)
        if pretrain_guidance_steps:
            gvars = self.pretrain_guidance(gvars, steps=pretrain_guidance_steps, batch_size=c.training.batch_size)
        elif random_guidance:
            # the demo's stand-in for stage 1, for a random guidance only
            gvars = self.pretrain_guidance(gvars)

        steps_per_epoch = max(1, self.num_batches("train", c.training.batch_size))
        tx = make_optimizer(c.optim.optimizer, lr_schedule(c, epochs, steps_per_epoch), c.optim.weight_decay,
                            c.optim.beta1, c.optim.eps, c.optim.grad_clip, lowmem=c.optim.lowmem)
        if not joint_train and gmod is None and gvars is not None:
            gmod = self.guidance_module(gvars)
        yhat_train = yhat_valid = None
        if precompute_yhat:
            hidx = head_indices if head_indices is not None else tuple(range(n_train_members))
            all_heads = tuple(range(c.diffusion.num_members))
            if yhat_cache_hit:
                z = np.load(yhat_cache_path)
                yh_all_train, yh_all_valid = z["train"], z["valid"]
                n_tr, n_va = len(self._dataset("train")), len(self._dataset("valid"))
                want = c.diffusion.num_members
                if (yh_all_train.shape[0] != n_tr or yh_all_train.shape[1] != want
                        or yh_all_valid.shape[0] != n_va or yh_all_valid.shape[1] != want):
                    raise ValueError(
                        f"y0_hat cache {yhat_cache_path} does not match this run: cached train "
                        f"{yh_all_train.shape} / valid {yh_all_valid.shape}, expected ({n_tr}, {want}, C) / "
                        f"({n_va}, {want}, C); delete the cache file")
                self.logger.info(f"loaded precomputed y0_hat from {yhat_cache_path}")
            else:
                yh_all_train = self.precompute_yhat(gmod, "train", all_heads, c.training.batch_size)
                yh_all_valid = self.precompute_yhat(gmod, "valid", all_heads, c.sampling.batch_size)
                if yhat_cache_path and self.writer:
                    np.savez(yhat_cache_path, train=yh_all_train, valid=yh_all_valid)
                    self.logger.info(f"cached y0_hat to {yhat_cache_path}")
            sel = list(hidx)
            yhat_train, yhat_valid = yh_all_train[:, sel, :], yh_all_valid[:, sel, :]
            gmod = None  # the guidance leaves the card before the member states arrive
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        mesh = self._maybe_mesh(c.training.batch_size) if member_idx is None else None
        fsdp = fsdp_plan(self.cond.state_dict(), mesh) if mesh is not None and c.model.fsdp else frozenset()
        states = create_member_states(self.cond, gen, tx, n_train_members, lowmem=c.optim.lowmem, device=dev,
                                      mesh=mesh, fsdp=fsdp)
        if mesh is not None:
            self.logger.info(f"training on mesh {dict(zip(mesh.mesh_dim_names, mesh_shape(mesh)))}"
                             + (" (joint)" if joint_train else "")
                             + (f" (fsdp: {len(fsdp)} leaves over data)" if fsdp else ""))
        start_epoch, best_acc = 0, -1.0
        aux_tx = aux_opt = gparams = None
        if joint_train:
            aux_tx = make_optimizer(c.aux_optim.optimizer, c.aux_optim.lr, c.aux_optim.weight_decay,
                                    c.aux_optim.beta1, c.aux_optim.eps, grad_clip=c.aux_optim.grad_clip)
            gparams = gvars["params"]
            aux_opt = aux_tx.init(gparams)
        # fresh runs use the zero-initialized debiased EMA; a resumed legacy
        # (copy-initialized) checkpoint keeps its convention
        ema_init_mode = "zero"
        if resume_from:
            ckpt_meta = load_checkpoint_meta(resume_from)
            if ckpt_meta.get("light"):
                raise ValueError(f"{resume_from} is a --light_ckpt checkpoint (no optimizer state); it can be "
                                 "evaluated/exported but not resumed")
            ckpt_lowmem = bool(ckpt_meta.get("lowmem", False))
            if ckpt_lowmem != bool(c.optim.lowmem):
                raise ValueError(
                    f"{resume_from} was trained with optim.lowmem={ckpt_lowmem} but this run has "
                    f"optim.lowmem={c.optim.lowmem}; pass --set optim.lowmem={str(ckpt_lowmem).lower()} to resume it")
            states, ck_guidance, meta = load_train_state(resume_from, device=dev, mesh=mesh, fsdp=fsdp)
            if ck_guidance is not None:
                gvars = ck_guidance
                if joint_train:
                    gparams = gvars["params"]
                elif not precompute_yhat:
                    gmod = self.guidance_module(gvars)
            ema_init_mode = meta.get("ema_init", "copy")
            if joint_train:
                aux_path = resume_from + "_aux"
                if os.path.exists(aux_path):
                    aux_opt = load_checkpoint(aux_path, map_location=dev)[0]["aux_opt"]
                else:
                    self.logger.warning("resumed a joint run without a *_aux checkpoint; aux optimizer state "
                                        "starts fresh")
            start_epoch = int(meta.get("epoch", -1)) + 1
            # the historical best, so a worse validation after the resume
            # does not overwrite the best checkpoint
            best_acc = float(meta.get("accuracy", -1.0))
            gen.manual_seed(derive_seed(seed, start_epoch))  # not a replay of the first run's draws
            self.logger.info(f"resumed from {resume_from} at epoch {start_epoch} (best acc {best_acc:.2f})")
        # noise_prior in training only with noise_prior_training (the
        # reference's live train loop never consults the flag)
        train_noise_prior = c.diffusion.noise_prior and c.diffusion.noise_prior_training
        compute = self._cond_template(n_train_members)
        on_mesh = dict(mesh=mesh, fsdp=fsdp)
        if joint_train:
            step_fn = make_joint_train_step(self.guidance, compute, tx, aux_tx, self.sched, n_train_members,
                                            c.data.num_classes, c.model.ema_rate, head_indices=head_indices,
                                            noise_prior=train_noise_prior, **on_mesh)
        elif precompute_yhat:
            step_fn = make_multi_member_step(compute, tx, self.sched, c.model.ema_rate, train_noise_prior,
                                             **on_mesh)
        else:
            step_fn = make_full_train_step(gmod, compute, tx, self.sched, n_train_members, c.data.num_classes,
                                           c.model.ema_rate, head_indices=head_indices,
                                           noise_prior=train_noise_prior, **on_mesh)

        global_step, images_seen, train_seconds = 0, 0, 0.0
        best_ckpt_path = None
        t0 = time.time()
        # a marker of an earlier completed run in this log dir must not
        # pass for this one while it is partial
        marker_path = os.path.join(self.log_dir, "train_complete.json")
        if self.writer and os.path.exists(marker_path):
            os.remove(marker_path)
        for epoch in range(start_epoch, epochs):
            t_epoch = time.perf_counter()
            for batch in self.batches("train", c.training.batch_size, shuffle=True, seed=epoch,
                                      with_indices=precompute_yhat):
                x, y = self._tensor_batch(*batch[:2])
                if joint_train:
                    states, gparams, aux_opt, aux_loss, losses = step_fn(states, gparams, aux_opt, x, y,
                                                                         generator=gen)
                    gvars = {"params": gparams}
                elif precompute_yhat:
                    y0, _ = one_hot_and_prototype(y, c.data.num_classes)
                    yh = torch.from_numpy(np.ascontiguousarray(yhat_train[batch[2]].transpose(1, 0, 2))).to(dev)
                    states, losses = step_fn(states, x.reshape(len(y), -1), y0, yh, generator=gen)
                else:
                    states, losses = step_fn(states, x, y, generator=gen)
                global_step += 1
                images_seen += len(y)
                if global_step % max(1, c.training.logging_freq // 10) == 0 or global_step == 1:
                    losses_host = losses.float().cpu().numpy()
                    self.logger.info(f"epoch {epoch} step {global_step} losses {np.round(losses_host, 4).tolist()} "
                                     f"({time.time() - t0:.1f}s)")
                    self.scalars.add_scalar("loss/mean", float(losses_host.mean()), global_step)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            train_seconds += time.perf_counter() - t_epoch
            if epoch % c.training.validation_freq == 0 or epoch + 1 == epochs:
                # validation draws from its own generator per epoch, not the
                # training stream
                val_gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, 1_000_000 + epoch))
                vmod = self.guidance_module(gvars) if joint_train else gmod
                acc = self._validate(vmod, states, val_gen, head_indices=head_indices, use_ema=eval_ema,
                                     ema_mode=ema_init_mode, precomputed_yhat=yhat_valid, mesh=mesh, fsdp=fsdp)
                del vmod
                self.scalars.add_scalar("accuracy", acc, global_step)
                self.logger.info(f"epoch {epoch}: validation majority-vote acc {acc:.2f}%")
                if acc > best_acc:
                    best_acc = acc
                    best_ckpt_path = self._save_best(
                        states, gvars, epoch, acc, member_idx, ema_init_mode, light_ckpt,
                        guidance_untouched, guidance_ckpt, vit_ckpt, mlp_dir, best_ckpt_path,
                        aux_opt if joint_train else None, mesh, fsdp)
        # written after every save: a script that resumes a pipeline tells
        # "training finished" from "a best checkpoint exists" (saved mid-run)
        if self.writer:
            with open(marker_path, "w") as f:
                json.dump({"best_accuracy": best_acc, "steps": global_step, "epochs": epochs,
                           "best_ckpt_path": best_ckpt_path}, f)
        if mesh is not None and best_ckpt_path is None:
            states = gather_tree(states, mesh, fsdp)  # the final weights are all a caller gets
        return {"best_accuracy": best_acc, "steps": global_step, "states": states, "guidance": gvars,
                "best_ckpt_path": best_ckpt_path, "ema_init": ema_init_mode,
                "train_seconds": train_seconds, "images": images_seen,
                "last_losses": losses.float().cpu().tolist() if global_step else None}

    def _save_best(self, states: MemberTrainState, gvars, epoch, acc, member_idx, ema_init_mode, light_ckpt,
                   guidance_untouched, guidance_ckpt, vit_ckpt, mlp_dir, previous, aux_opt,
                   mesh=None, fsdp=()) -> str:
        """The best checkpoint, named as the reference names it; a light one
        replaces the previous best on disk. On a mesh every rank calls this
        and rank 0 writes (``save_train_state``)."""
        c = self.config
        path = os.path.join(self.log_dir, best_checkpoint_name(
            "diffu" if member_idx is not None else "diffu_all",
            member_idx if member_idx is not None else 0, epoch, acc))
        meta = {"epoch": epoch, "accuracy": acc, "kind": "diffusion_members", "light": light_ckpt,
                # the guidance head(s) the member(s) trained against
                "member_idx": member_idx,
                "ema_init": ema_init_mode, "ema_rate": float(c.model.ema_rate),
                "lowmem": bool(c.optim.lowmem)}
        ckpt_gvars = gvars
        if light_ckpt and guidance_untouched and (guidance_ckpt or vit_ckpt):
            # the guidance IS the immutable stage-1 artifacts: store their
            # paths, absolute and relative to the checkpoint
            ckpt_gvars = None
            srcs = {"guidance_ckpt": guidance_ckpt, "vit_ckpt": vit_ckpt, "mlp_dir": mlp_dir}
            meta["guidance_src"] = {k: os.path.abspath(v) if v else None for k, v in srcs.items()}
            meta["guidance_src_rel"] = {k: os.path.relpath(os.path.abspath(v), path) if v else None
                                        for k, v in srcs.items()}
        save_train_state(path, states, meta, guidance=ckpt_gvars, light=light_ckpt,
                         light_dtype=self.dtype if light_ckpt else None, mesh=mesh, fsdp=fsdp)
        if self.writer and light_ckpt and previous and previous != path:
            shutil.rmtree(previous, ignore_errors=True)
        if self.writer and aux_opt is not None:
            save_checkpoint(path + "_aux", {"aux_opt": aux_opt}, {"kind": "aux_optimizer"})
        self.logger.info(f"saved best ckpt to {path}")
        return path

    @torch.no_grad()
    def _validate(self, gmod: Optional[SEViTGuidance], states: MemberTrainState, generator: torch.Generator,
                  mc_trials: int = 1, head_indices=None, use_ema: bool = False, ema_mode: str = "zero",
                  precomputed_yhat: Optional[np.ndarray] = None, mesh=None, fsdp=()) -> float:
        """Majority-vote accuracy on the validation split, the in-training
        quality gate. ``head_indices`` aligns the guidance heads with the
        trained members; ``use_ema`` validates the EMA; the sampler strides
        by ``diffusion.val_ddim_steps`` (else ``ddim_steps``). On a mesh each
        rank samples its member rows (its FSDP leaves gathered whole)."""
        c = self.config
        params = ema_read(states.ema, c.model.ema_rate, states.step, ema_mode) if use_ema else states.params
        tensors = {**params, **states.batch_stats}
        if fsdp:
            tensors = {k: gather_data(v, mesh, dim=1) if k in fsdp else v for k, v in tensors.items()}
        model = self.members_module(tensors)
        n_members = states.step.shape[0] * (1 if mesh is None else mesh_shape(mesh)[0])
        idx = tuple(int(i) for i in (head_indices if head_indices is not None else range(n_members)))
        val_steps = c.diffusion.val_ddim_steps or c.diffusion.ddim_steps
        tau = ddim_timesteps(self.sched.num_timesteps, val_steps, c.diffusion.skip_type).tolist() if val_steps else None
        pre = precomputed_yhat is not None
        correct = total = 0
        for batch in self.batches("valid", c.sampling.batch_size, with_indices=pre):
            x, y = self._tensor_batch(*batch[:2])
            if pre:
                yh = torch.from_numpy(np.ascontiguousarray(precomputed_yhat[batch[2]].transpose(1, 0, 2)))
                yh = yh.to(self.device)
            else:
                yh = torch.softmax(gmod.heads_subset(x, idx).float(), dim=-1)
            samples = nested_ensemble_sample(model, x.reshape(len(y), -1), yh, self.sched, mc_trials=mc_trials,
                                             tau=tau, eta=c.diffusion.ddim_eta, noise_prior=c.diffusion.noise_prior,
                                             generator=generator, mesh=mesh)
            m, k, b, cl = samples.shape
            mv = majority_vote(samples.reshape(m * k, b, cl).float())
            correct += int((mv == y).sum())
            total += len(y)
        return 100.0 * correct / max(total, 1)

    def _maybe_mesh(self, batch_size: int):
        """The JAX runner's ('member', 'data') mesh over the ranks of an
        initialized process group of more than one rank (one per batch size,
        made once: every rank calls this alike): across nodes
        (``make_multislice_mesh``) when the ranks span several and its data
        axis tiles the batch, else the most ranks whose data axis does. A
        rank left out of that mesh runs unsharded (None), as does a lone
        process; one that sees several cards says how to launch a rank a
        card."""
        if not (torch.distributed.is_available() and torch.distributed.is_initialized()) \
                or torch.distributed.get_world_size() == 1:
            if self.device.type == "cuda" and torch.cuda.device_count() > 1:
                n = torch.cuda.device_count()
                self.logger.warning(f"{n} cards are visible to one process; the port runs a rank a card: launch "
                                    f"`torchrun --nproc_per_node {n} -m ladine_tpu_torch.cli.main ...` for the "
                                    f"mesh (now on {self.device} alone)")
            return None
        if batch_size not in self._meshes:
            self._meshes[batch_size] = self._make_mesh(batch_size)
        mesh = self._meshes[batch_size]
        return mesh if mesh is not None and in_mesh(mesh) else None

    def _make_mesh(self, batch_size: int):
        world = torch.distributed.get_world_size()
        members, device_type = self.config.diffusion.num_members, self.device.type
        slices = group_devices_by_slice(range(world))
        if len(slices) > 1:
            # the member axis across nodes: the gradient sums stay on NVLink
            mesh = make_multislice_mesh(num_members=members, device_type=device_type)
            if batch_size % mesh_shape(mesh)[1] == 0:
                self.logger.info(describe_mesh(mesh, num_slices=len(slices)))
                return mesh
            self.logger.warning(f"multislice data axis {mesh_shape(mesh)[1]} does not tile batch {batch_size}; "
                                "falling back to flat rank packing")
        for n in range(world, 1, -1):
            m_dim, d_dim = factor_mesh(n, members)
            if batch_size % d_dim == 0:
                self.logger.info(f"mesh: {n} devices as (member={m_dim}, data={d_dim})")
                return make_mesh(n, num_members=members, device_type=device_type)
        self.logger.warning(f"no rank count <= {world} tiles batch {batch_size}; every rank runs unsharded")
        return None

    def pretrain_guidance(self, gvars: Dict[str, Tensors], steps: int = 60, batch_size: int = 8):
        """Fit the ViT and the mapping MLPs with cross-entropy on all K+1
        heads (Adam 1e-3, no clipping), float32 masters through the
        compute module: the demo's stand-in for stage 1, and
        ``--pretrain_guidance``."""
        tx = make_optimizer("Adam", 1e-3, grad_clip=None)
        params = gvars["params"]
        opt_state = tx.init(params)

        def loss_fn(p, images, labels):
            logp = torch.log_softmax(Fn.call(self.guidance, p, images).float(), dim=-1)  # (K+1, B, C)
            index = labels.reshape(1, -1, 1).expand(logp.shape[0], -1, 1)
            return -logp.gather(-1, index).mean(), None

        i, loss = 0, torch.zeros(())
        while i < steps:
            for images, labels in self.batches("train", batch_size, shuffle=True, seed=i):
                x, y = self._tensor_batch(images, labels)
                loss, _, grads = Fn.value_and_grad(lambda p: loss_fn(p, x, y), params)
                tx.step(params, grads, opt_state)
                i += 1
                if i >= steps:
                    break
        self.logger.info(f"demo guidance pre-trained ({steps} steps, CE {float(loss):.4f})")
        return {**gvars, "params": params}

    @torch.no_grad()
    def evaluate_guidance(self, gvars: Dict[str, Tensors], split: str = "valid") -> float:
        """The guidance's accuracy by majority vote over its K+1 heads."""
        c = self.config
        gmod = self.guidance_module(gvars)
        correct = total = 0
        for images, labels in self.batches(split, c.testing.batch_size):
            x, y = self._tensor_batch(images, labels)
            votes = gmod(x).argmax(-1)  # (K+1, B)
            counts = (votes[..., None] == torch.arange(c.data.num_classes, device=self.device)).sum(0)
            correct += int((counts.argmax(-1) == y).sum())
            total += len(y)
        acc = 100.0 * correct / max(total, 1)
        self.logger.info(f"guidance majority-vote accuracy ({split}): {acc:.2f}%")
        return acc

    # ------------------------------------------------------------- test

    def _evaluate(self, split: str, generator, stacked: Tensors, gvars, eval_cfg: EvalConfig, pipeline=None):
        c = self.config
        return evaluate_ensemble(
            self.guidance_module(gvars), self.members_module(stacked), self.sched,
            self.batches(split, c.testing.batch_size, drop_last=c.testing.drop_last), eval_cfg,
            generator=generator, mesh=self._maybe_mesh(c.testing.batch_size), device=self.device,
            pipeline=pipeline)

    def test(self, generator: torch.Generator, stacked: Tensors, gvars, eval_cfg: EvalConfig,
             pipeline=None) -> Dict[str, Any]:
        """The robust evaluation over the test split (``evaluate_ensemble``;
        ``pipeline``: one of its pipelines to reuse)."""
        report = self._evaluate("test", generator, stacked, gvars, eval_cfg, pipeline)
        self.logger.info(
            f"test: mv-acc {report['majority_vote_accuracy']:.2f}% acc {report['mean_confidence_accuracy']:.2f}% "
            f"ece {report['ece']:.4f} nll {report['nll']:.4f} brier {report['brier']:.4f}")
        return report

    def calibrate(self, generator: torch.Generator, stacked: Tensors, gvars, eval_cfg: EvalConfig) -> Dict[str, Any]:
        """Validation MC samples drawn once, then Nelder-Mead on the cached
        objective; the report at the best temperature, with the vote-limit
        diagnostic (as T -> 0 the confidence becomes the MC vote fraction)."""
        report = self._evaluate("valid", generator, stacked, gvars, eval_cfg)
        t_best, ece_best = temperature_search(report["samples"], report["labels"])
        self.logger.info(f"calibrated temperature {t_best:.4f} (ece {ece_best:.4f})")
        recal = compute_report(report["samples"], report["labels"], t_best)
        recal["calibrated_temperature"] = t_best
        ece_vote = calibration_objective(report["samples"], report["labels"], 1e-6)
        recal["ece_vote_fraction_limit"] = float(ece_vote)
        recal["temperature_at_vote_limit"] = bool(ece_best >= ece_vote - 1e-6 and t_best < 0.01)
        return recal
