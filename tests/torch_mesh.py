"""Multi-rank runs of the port's mesh (``ladine_tpu_torch/parallel/``) on the CPU.

``run_world(fn, world, tmp, *args)`` spawns ``world`` ranks over ``gloo``
(rendezvous through a file in ``tmp``, so that test workers share no TCP
port; every group times out after two minutes, so a rank that dies cannot
hang the suite), runs ``fn(*args)`` on each with torch on one thread, and
returns rank 0's result. A rank's exception is re-raised in the caller by
``torch.multiprocessing.spawn``. This module imports torch and the port
alone, so a spawned rank loads neither JAX nor the test files.

The builders make the same tiny modules and inputs from seeds in every
process (the widths of ``configs/synthetic_tiny.yml``: images 32 x 32,
feature = hidden = 32, 50 timesteps, batch 16; the guidance ViT of embed
32, patch 8, 5 blocks, 2 heads, MLPs 32-16-8), so a test compares a
sharded run against the one-process run of the same seeds.
"""

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ladine_tpu_torch.models import ConditionalModel, SEViTGuidance, init_random_
from ladine_tpu_torch.ops import DiffusionSchedule

T_STEPS, B, IMG = 50, 16, 32
DATA_DIM = IMG * IMG * 3
FEATURE = 32
LR = 1e-3


def _entry(rank, world, rdzv, out, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, tmp, *args):
    """``fn(*args)`` on ``world`` gloo ranks; rank 0's result."""
    rdzv, out = os.path.join(str(tmp), "rdzv"), os.path.join(str(tmp), "result.pt")
    mp.spawn(_entry, args=(world, rdzv, out, fn, args), nprocs=world, join=True)
    return torch.load(out, weights_only=False)


def guidance(num_members: int) -> SEViTGuidance:
    g = SEViTGuidance(num_classes=2, num_members=num_members, vit_depth=5, img_size=IMG, patch_size=8,
                      embed_dim=32, num_heads=2, mlp_hidden_dims=(32, 16, 8), device="cpu")
    return init_random_(g, torch.Generator().manual_seed(0))


def members(m: int, seed: int = 1, n_steps: int = T_STEPS + 1) -> ConditionalModel:
    model = ConditionalModel(m, DATA_DIM, FEATURE, FEATURE, 2, n_steps, device="cpu")
    return init_random_(model, torch.Generator().manual_seed(seed))


def compute_module(m: int) -> ConditionalModel:
    return ConditionalModel(m, DATA_DIM, FEATURE, FEATURE, 2, T_STEPS + 1, device="meta", dtype=torch.float32)


def schedule(steps: int = T_STEPS) -> DiffusionSchedule:
    return DiffusionSchedule.create("linear", steps, 1e-4, 0.02, device="cpu")


def batch(seed: int, n: int = B):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((n, IMG, IMG, 3), dtype=np.float32))
    return images, torch.from_numpy(rng.integers(0, 2, n))


def draws(seed: int, m: int, n: int = B):
    """Injected t (m, n) and noise (m, n, 2), made with numpy."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, T_STEPS, (m, n))),
            torch.from_numpy(rng.standard_normal((m, n, 2)).astype(np.float32)))


def whole(state):
    """A state's tensors as numpy, by part."""
    return {"params": {k: v.numpy().copy() for k, v in state.params.items()},
            "batch_stats": {k: v.numpy().copy() for k, v in state.batch_stats.items()},
            "mu": {k: v.float().numpy().copy() for k, v in state.opt_state["mu"].items()},
            "ema": {k: v.float().numpy().copy() for k, v in state.ema.items()},
            "count": state.opt_state["count"].numpy().copy(), "step": state.step.numpy().copy()}


# --------------------------------------------------------------- train steps

TRAIN_CASES = {
    # name: (step kind, mesh rows, members, fsdp min_size or None, lowmem, injected draws, clipping).
    # Adam's step and a clipped gradient do not see the gradient's scale,
    # its first moments without clipping do: the cases without clipping
    # hold the loss scale (the sum over 'data' over its size), those with
    # it the norm summed over FSDP shards.
    "multi_2x2": ("multi", [[0, 1], [2, 3]], 4, None, False, True, None),
    "multi_1x4_drawn": ("multi", [[0, 1, 2, 3]], 5, None, False, False, 1.0),
    "full_2x2": ("full", [[0, 1], [2, 3]], 4, None, False, True, None),
    "full_1x4": ("full", [[0, 1, 2, 3]], 5, None, False, True, None),
    "joint_2x2": ("joint", [[0, 1], [2, 3]], 4, None, False, True, None),
    "joint_1x4": ("joint", [[0, 1, 2, 3]], 5, None, False, True, 1.0),
    "fsdp_1x4": ("multi", [[0, 1, 2, 3]], 5, 64, False, True, 1.0),
    "fsdp_1x4_lowmem": ("multi", [[0, 1, 2, 3]], 5, 64, True, False, None),  # chunks of 5000 (SMALL_CHUNK)
    "fsdp_full_2x2": ("full", [[0, 1], [2, 3]], 4, 64, False, True, 1.0),
}


SMALL_CHUNK = 5000  # lowmem chunk edges fall inside the shards: 1000 columns of 5 members


def train_case(name: str, mesh=None) -> dict:
    """One case of :data:`TRAIN_CASES` (one step from a fresh state), on
    ``mesh`` or in one process: the losses, the whole state after, and the
    generator's next draw (the ranks' generators must stay in step with
    one process's)."""
    from ladine_tpu_torch.train import lowmem as L

    chunk = L.CHUNK
    L.CHUNK = SMALL_CHUNK if TRAIN_CASES[name][4] else chunk
    try:
        return _train_case(name, mesh)
    finally:
        L.CHUNK = chunk


def _train_case(name: str, mesh) -> dict:
    from ladine_tpu_torch.parallel import fsdp_plan, gather_tree
    from ladine_tpu_torch.train import (create_member_states, make_full_train_step, make_joint_train_step,
                                        make_multi_member_step, make_optimizer)
    from ladine_tpu_torch.ops import one_hot_and_prototype

    kind, _, m, min_size, lowmem, injected, clip = TRAIN_CASES[name]
    tx = make_optimizer("Adam", LR, grad_clip=clip, lowmem=lowmem)
    fsdp = frozenset()
    if mesh is not None and min_size is not None:
        fsdp = fsdp_plan(compute_module(m).state_dict(), mesh, min_size=min_size)
    gen = torch.Generator().manual_seed(7)
    state = create_member_states(compute_module(m), gen, tx, m, lowmem=lowmem, device="cpu", mesh=mesh, fsdp=fsdp)
    sched = schedule()
    g = guidance(5)
    out = {"losses": [], "fsdp": sorted(fsdp)}
    on_mesh = dict(mesh=mesh, fsdp=fsdp)
    if kind == "multi":
        step = make_multi_member_step(compute_module(m), tx, sched, **on_mesh)
    elif kind == "full":
        step = make_full_train_step(g, compute_module(m), tx, sched, m, 2, **on_mesh)
    else:
        aux_tx = make_optimizer("Adam", LR, grad_clip=clip)
        gparams = {k: v.clone() for k, v in g.state_dict().items()}
        aux_opt = aux_tx.init(gparams)
        step = make_joint_train_step(g, compute_module(m), tx, aux_tx, sched, m, 2, **on_mesh)
        out["aux_loss"] = []
    for i in range(1):
        images, labels = batch(100 + i)
        t, noise = draws(200 + i, m) if injected else (None, None)
        if kind == "multi":
            y0, _ = one_hot_and_prototype(labels, 2)
            yh = torch.softmax(torch.from_numpy(np.random.default_rng(300 + i).standard_normal((m, B, 2))
                                                .astype(np.float32)), -1)
            state, losses = step(state, images.reshape(B, -1), y0, yh, generator=gen, t=t, noise=noise)
        elif kind == "full":
            state, losses = step(state, images, labels, generator=gen, t=t, noise=noise)
        else:
            state, gparams, aux_opt, aux_loss, losses = step(state, gparams, aux_opt, images, labels,
                                                             generator=gen, t=t, noise=noise)
            out["aux_loss"].append(float(aux_loss))
        out["losses"].append(losses.numpy().copy())
    if mesh is not None:
        state = gather_tree(state, mesh, fsdp)
    out["state"] = whole(state)
    out["next_draw"] = int(torch.randint(0, 2**31, (1,), generator=gen))
    if kind == "joint":
        out["gparams"] = {k: v.numpy().copy() for k, v in gparams.items()}
    return out


def train_world(jax_inputs: str, ckpt_dir: str, one_process_ckpt: str) -> dict:
    """Every train case on its mesh; the port's full step on (2, 2) from
    ``jax_inputs`` (a JAX state, guidance and draws carried over); a
    checkpoint written on (2, 2) into ``ckpt_dir`` and the one-process
    ``one_process_ckpt`` read back on (2, 2); the multislice mesh's log
    line."""
    from ladine_tpu_torch.parallel import (describe_mesh, fsdp_plan, gather_tree, make_mesh, make_multislice_mesh,
                                           shard_tree)
    from ladine_tpu_torch.parallel.mesh import mesh_of, mesh_shape
    from ladine_tpu_torch.train import make_full_train_step, make_optimizer
    from ladine_tpu_torch.utils import load_train_state, save_train_state

    out = {name: train_case(name, mesh_of(spec[1], "cpu")) for name, spec in TRAIN_CASES.items()}

    inp = torch.load(jax_inputs, weights_only=False)
    mesh = mesh_of([[0, 1], [2, 3]], "cpu")
    g = guidance(4)
    g.load_state_dict(inp["guidance"])
    step = make_full_train_step(g, compute_module(4), make_optimizer("Adam", LR), schedule(), 4, 2, mesh=mesh)
    state, losses = step(shard_tree(inp["state"], mesh), inp["images"], inp["labels"], t=inp["t"],
                         noise=inp["noise"])
    out["vs_jax"] = {"mesh": mesh_shape(mesh), "losses": losses.numpy().copy(),
                     "params": {k: v.numpy().copy() for k, v in gather_tree(state, mesh).params.items()}}

    out["fsdp_plan"] = {n: sorted(fsdp_plan(inp["state"], mesh, min_size=n)) for n in (inp["min_size"], 2**18)}
    fsdp = fsdp_plan(inp["state"], mesh, min_size=inp["min_size"])
    save_train_state(ckpt_dir, shard_tree(inp["state"], mesh, fsdp), {"kind": "diffusion_members"},
                     mesh=mesh, fsdp=fsdp)
    read, _, _ = load_train_state(one_process_ckpt, mesh=mesh, fsdp=fsdp)
    out["ckpt_read"] = whole(gather_tree(read, mesh, fsdp))
    out["ckpt_files"] = sorted(os.listdir(ckpt_dir))

    sl = make_multislice_mesh(num_members=2, num_slices=2, device_type="cpu")
    out["multislice"] = (mesh_shape(sl), sl.mesh.tolist(), describe_mesh(sl, 2),
                         describe_mesh(make_mesh(4, num_members=1, device_type="cpu"), 2))
    return out


# ---------------------------------------------------------------- inference

INFER_MEMBERS, INFER_STEPS = 4, 20
EVAL_BATCHES = (8, 5)  # 5 does not tile a data axis of 2: a tail batch


def eval_config():
    from ladine_tpu_torch.infer import EvalConfig

    return EvalConfig(mc_trials=3, noise_std=0.05, crop=0.2, attack_name="PGD", attack_eps=0.03, ddim_steps=5)


def member_bytes(model, *forms) -> int:
    """The bytes of the storages behind ``model``'s tensors and the int8
    ``forms`` (nested tuples and dicts of tensors), each storage once: what
    the members cost a rank, views of a larger tensor counted whole."""
    tensors = list(model.state_dict().values())
    stack = list(forms)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return sum(storages.values())


def save_infer_artifact(path: str) -> None:
    """The inference cases' modules as a ``Predictor.save`` directory."""
    from ladine_tpu_torch.infer import Predictor

    Predictor(guidance=guidance(INFER_MEMBERS), model=members(INFER_MEMBERS, 2, INFER_STEPS + 1),
              sched=schedule(INFER_STEPS), device="cpu").save(path)


def infer_case(artifact: str, mesh=None) -> dict:
    """The engine, ``Predictor.predict`` at ``parity`` and ``fast``,
    ``Predictor.load`` of ``artifact`` (:func:`save_infer_artifact`) at
    ``fast`` and ``evaluate_ensemble`` on the same seeds, on ``mesh`` or in
    one process, batches of 8 and of 5 (a tail); the bytes of the members
    each predictor and the pipeline hold."""
    from ladine_tpu_torch.infer import Predictor, evaluate_ensemble, make_eval_pipeline
    from ladine_tpu_torch.infer.engine import nested_ensemble_sample
    from ladine_tpu_torch.infer.serve import select_members
    from ladine_tpu_torch.parallel import member_slice

    g, model, sched = guidance(INFER_MEMBERS), members(INFER_MEMBERS, 2, INFER_STEPS + 1), schedule(INFER_STEPS)
    out = {}
    for b in EVAL_BATCHES:
        images, _ = batch(400 + b, b)
        yh = torch.softmax(g.heads_subset(images, tuple(range(INFER_MEMBERS))).float(), -1)
        rows = model if mesh is None else select_members(model, member_slice(mesh, INFER_MEMBERS))
        out[f"engine_{b}"] = nested_ensemble_sample(
            rows, images.reshape(b, -1), yh, sched, mc_trials=3, generator=torch.Generator().manual_seed(b),
            mesh=mesh).numpy()
        for preset in ("parity", "fast"):
            p = Predictor.from_preset(preset, guidance=g, model=model, sched=sched, mc_trials=3, seed=b,
                                      device="cpu", mesh=mesh)
            out[f"{preset}_{b}"] = p.predict(images.numpy())
            out[f"bytes_{preset}"] = member_bytes(p.model, p._qmember, p._qenc)
        p = Predictor.load(artifact, preset="fast", mc_trials=3, seed=b, device="cpu", mesh=mesh)
        out[f"load_{b}"] = p.predict(images.numpy())
        out["bytes_load"] = member_bytes(p.model, p._qmember, p._qenc)
    out["refused"] = []
    for call in (p.save, p.export_serving) if mesh is not None else ():
        try:
            call(artifact + "_again")
        except ValueError:
            out["refused"].append(call.__name__)
    batches = [tuple(t.numpy() for t in batch(500 + b, b)) for b in EVAL_BATCHES]
    int8 = make_eval_pipeline(g, model, sched, dataclasses.replace(eval_config(), use_int8=True, use_int8_encode=True),
                              mesh=mesh, device="cpu").program
    out["bytes_eval"] = member_bytes(int8.model, [v for k, v in int8._buffers.items()
                                                  if k.startswith(("q_lin", "q_enc"))])
    report = evaluate_ensemble(g, model, sched, batches, eval_config(), torch.Generator().manual_seed(3),
                               mesh=mesh, device="cpu")
    out["eval"] = {k: report[k] for k in ("samples", "majority_vote_accuracy", "ece", "nll")}
    return out


def infer_world(artifact: str) -> dict:
    from ladine_tpu_torch.parallel.mesh import mesh_of

    return infer_case(artifact, mesh_of([[0, 1], [2, 3]], "cpu"))


# ---------------------------------------------------------------- the CLI

# the demo's guidance pre-trained 5 steps (its default 60 costs each process ~10 s)
CLI_ARGS = ["--demo", "--train", "--device", "cpu", "--n_epochs", "1", "--timesteps", "10", "--pretrain_guidance", "5",
            "--fsdp"]


def cli_world(exp: str, world: int) -> int:
    """``cli.main`` as ``torchrun`` starts it on each rank (its environment
    variables; the group already made, which ``main`` then uses)."""
    from ladine_tpu_torch.cli import main as main_cli

    rank = dist.get_rank()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    return main_cli.main(CLI_ARGS + ["--exp", exp])


# ---------------------------------------------------------------- on the card


def cuda_parity_case(mesh=None) -> dict:
    """A small bfloat16 ``parity`` predictor on the card (ancestral, 50
    steps), a batch of 4 graphed (first call captures, second replays):
    its outputs and the kernels' launches of the replay."""
    from ladine_tpu_torch.infer import Predictor
    from ladine_tpu_torch.kernels import launch_counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator().manual_seed(4)
    cpu = (guidance(2), init_random_(ConditionalModel(2, DATA_DIM, 64, 64, 2, T_STEPS + 1, device="cpu"), gen))
    mods = (SEViTGuidance(num_classes=2, num_members=2, vit_depth=5, img_size=IMG, patch_size=8, embed_dim=32,
                          num_heads=2, mlp_hidden_dims=(32, 16, 8), device=dev, dtype=torch.bfloat16),
            ConditionalModel(2, DATA_DIM, 64, 64, 2, T_STEPS + 1, device=dev, dtype=torch.bfloat16))
    for src, dst in zip(cpu, mods):
        dst.load_state_dict(src.state_dict())
    pred = Predictor.from_preset("parity", guidance=mods[0], model=mods[1], mc_trials=4, device=dev,
                                 sched=DiffusionSchedule.create("linear", T_STEPS, device=dev), mesh=mesh)
    images = batch(7, 4)[0].numpy()
    pred.predict(images)
    launch_counts.clear()
    out = pred.predict(images)
    return {"out": out, "launches": dict(launch_counts)}


def cuda_parity_world() -> dict:
    from ladine_tpu_torch.parallel.mesh import mesh_of

    return cuda_parity_case(mesh_of([[0, 1]], "cuda"))
