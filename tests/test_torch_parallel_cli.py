"""``cli.main --train --demo --fsdp`` on two ``gloo`` ranks on the CPU
(one epoch, T = 10, the guidance pre-trained 5 steps;
``tests/torch_mesh.py::cli_world`` sets torchrun's variables on each rank)
against the same command in one process: the runner meshes the 2 ranks as
(member 1, data 2) for the demo's 5 members (no leaf of the demo reaches
``fsdp_plan``'s 2^18 elements, so ``--fsdp`` adds nothing at these widths,
as in the JAX package), and rank 0 alone writes. The best checkpoint
carries the same name (its validation accuracy), loads in one
process with the one-process run's metadata, and its state equals the
one-process run's within the sharded step's bars (``test_torch_parallel.py``:
parameters to abs 2.1e-3, Adam's sign flips at the gradient's noise floor,
here over the epoch's 3 steps; running statistics to 1e-3 of their leaf's
largest); the scalars are logged once."""

import glob
import json
import os

import pytest
import torch

import torch_mesh as TM
from ladine_tpu_torch.cli import main as main_cli
from ladine_tpu_torch.utils import load_train_state
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    assert TM.run_world(TM.cli_world, 2, tmp, str(tmp / "mesh"), 2) == 0
    assert main_cli.main(TM.CLI_ARGS + ["--exp", str(tmp / "one")]) == 0
    return tmp


def _ckpt(root):
    (path,) = glob.glob(os.path.join(root, "logs", "run", "diffu_all0_ckpt_best_*"))
    return path


def test_checkpoint_of_two_ranks_loads_in_one_process_and_matches(runs):
    mesh_path, one_path = _ckpt(runs / "mesh"), _ckpt(runs / "one")
    assert os.path.basename(mesh_path) == os.path.basename(one_path)
    assert sorted(os.listdir(mesh_path)) == ["ladine_meta.json", "tree.pt"]
    got, _, meta = load_train_state(mesh_path)
    want, _, want_meta = load_train_state(one_path)
    assert meta == want_meta
    for k, v in want.params.items():
        assert got.params[k].shape == v.shape
        torch.testing.assert_close(got.params[k], v, rtol=0, atol=2.1e-3)
    for k, v in want.batch_stats.items():
        # a running mean after a pre-BatchNorm bias, whose exact-zero
        # gradient steps by noise, moves with that bias (2e-4 measured)
        torch.testing.assert_close(got.batch_stats[k], v, rtol=0, atol=1e-3 * float(v.abs().max()))
    torch.testing.assert_close(got.step, want.step, rtol=0, atol=0)


def test_rank_zero_alone_writes(runs):
    logs = [os.path.join(runs / d, "logs", "run") for d in ("mesh", "one")]
    lines = [open(os.path.join(d, "scalars.jsonl")).read().splitlines() for d in logs]
    assert len(lines[0]) == len(lines[1]) > 0
    assert [json.loads(x)["tag"] for x in lines[0]] == [json.loads(x)["tag"] for x in lines[1]]
    done = [json.load(open(os.path.join(d, "train_complete.json"))) for d in logs]
    assert done[0]["steps"] == done[1]["steps"] and done[0]["best_accuracy"] == done[1]["best_accuracy"]
    log = open(os.path.join(logs[0], "stdout.txt")).read()
    # at the demo's widths no leaf reaches fsdp_plan's 2^18 elements, in
    # either package: --fsdp shards nothing more here
    assert "mesh: 2 devices as (member=1, data=2)" in log and "training on mesh" in log
