"""The harness on the CPU: no result without a card, new cells, traffic,
metrics and work counts found by name, ``correct`` false under each fault
of ``portbench/faults.py``, and the control separated from the program."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb_tiny import ROOT, tiny_bench, tiny_config
from portbench import faults, harness, judge
from portbench.families import ladine as family
from portbench.reference import ladine as reference

SEED = 2**31 + 12345  # past 32 signed bits, as a check's seeds may be


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_exits_without_a_card():
    assert not torch.cuda.is_available()
    p = _run(["--workload", "parity_eval_b8", "--seed", str(SEED), "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_run_exits_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    p = _run(["--workload", "serving_eval_b70", "--seed", "1", "--seconds", "1", "--trace", "1"], tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


def _digest(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest() for p in base.rglob("*") if p.is_file()}


def test_new_config_traffic_metric_and_work_are_found_by_name(tmp_path):
    spec, base = tiny_bench(tmp_path)
    before = _digest(base)
    (base / "work" / "dummy.py").write_text("def per_request(cfg):\n    return 2 * cfg['num_members']\n")
    (base / "metrics" / "dummy_work.py").write_text(
        "def read(run):\n"
        "    return run.work('dummy').per_request(run.config) * len(run.completed)\n")
    (base / "traffic" / "closed_b3.json").write_text(json.dumps(
        dict(kind="closed", batch=3, pool=12, compare_rows=3)))
    (base / "configs" / "tiny_extra.json").write_text(json.dumps(tiny_config("ladine_chestxray_parity_bf16")))
    spec["configs"].append(dict(name="tiny_extra", source="test", file="portbench/configs/tiny_extra.json",
                                reduced=[], why="test"))
    spec["workloads"].append(dict(name="extra_b3", config="tiny_extra", traffic="closed_b3", chips=1, why="test"))
    for m in spec["end_to_end"]:
        if m["name"] == "eval_images_per_s":
            m["workloads"].append("extra_b3")
    spec["per_layer"].append(dict(name="dummy_work", unit="ops", better="higher", source="program_counter",
                                  layer="serving program", moves="eval_images_per_s", workloads=["extra_b3"]))
    result, checks = harness.run_cell(spec, "extra_b3", SEED, 1.0, True, device="cpu", base=base)
    assert {p: d for p, d in _digest(base).items() if p in before} == before  # no file there was edited
    n = result["attempted"]
    assert n >= 1 and result["metrics"]["dummy_work"]["value"] == 10 * n
    assert "k1_roofline.eval" not in result["metrics"]  # no trace on the CPU
    assert result["correct"], checks


CELLS = ["parity_eval_b8", "serving_eval_b70", "serving_open_poisson"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    spec, base = bench
    result, checks = harness.run_cell(spec, cell, SEED, 1.0, False, device="cpu", base=base)
    assert result["correct"] and result["failed"] == 0, checks
    config = next(w["config"] for w in spec["workloads"] if w["name"] == cell)
    limits = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())["limits"]
    assert set(checks) == set(limits)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_makes_the_run_incorrect(bench, cell, fault, monkeypatch):
    spec, base = bench
    for owner, name, fn in faults.patches(fault):
        monkeypatch.setattr(owner, name, fn)
    result, checks = harness.run_cell(spec, cell, SEED, 1.0, False, device="cpu", base=base)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", ["ladine_chestxray_parity_bf16", "ladine_chestxray_serving_int8"])
def test_control_reads_three_times_the_program(name):
    """The configuration's control, in the program's place, against the
    reference: at these widths too it departs by three times the bf16
    program or more on the compared numbers."""
    cfg = tiny_config(name, "bfloat16")
    readings = {"program": [], "control": []}
    for seed in (11, 12, 13):
        weights = family.make_weights(cfg, seed, "cpu")
        images = family.image_pool(cfg, 16, seed, "cpu")
        z = family.noise(cfg, 16, seed, 0, "cpu")
        ref = reference.predict(cfg, *weights, torch.as_tensor(images), z, cfg.get("int_bits"))
        prog = family.outputs(family.build(cfg, weights, "cpu").predict(images, noise=z))
        ctl = cfg["control"]
        control = family.as_outputs(reference.predict(cfg, *weights, torch.as_tensor(images), z,
                                                      ctl.get("reference_int_bits"), ctl.get("reference_fp8", False)))
        readings["program"].append(judge.gaps(prog, ref))
        readings["control"].append(judge.gaps(control, ref))
    for number in set(cfg["limits"]) - {"probs_gap", "vote_gap"}:  # those two catch gross faults, not the control
        low = max(r[number] for r in readings["program"])
        high = min(r[number] for r in readings["control"])
        print(number, low, high)
        assert high >= 3 * low, (number, readings)


@pytest.mark.parametrize("cell", ["parity_eval_b8", "serving_open_poisson"])
def test_control_reads_the_planted_faults(bench, cell):
    """``portbench.control --fault``: each fault read on one seed's weights,
    and each makes the run incorrect."""
    from portbench import control

    spec, base = bench
    names = ["a_wrong_tap", "votes_flipped"]
    line = control.fault_readings(spec, cell, SEED, names, "cpu", base=base)
    assert sorted(line["faults"]) == sorted(names)
    assert not any(f["correct"] for f in line["faults"].values()), line


def test_planted_restores_what_it_patched():
    from ladine_tpu_torch.models.vit import ViT

    taps = ViT.__dict__["_taps"]
    with faults.planted("a_wrong_tap"):
        assert ViT.__dict__["_taps"] is not taps
    assert ViT.__dict__["_taps"] is taps
