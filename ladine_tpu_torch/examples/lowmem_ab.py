"""Training-convergence A/B of ``optim.lowmem`` (bfloat16 Adam moments and
EMA with stochastic rounding) against float32 state.

The port's counterpart of ``scripts/lowmem_ab.py``, with its arms:
``cli.main --demo --train --n_epochs 6 --timesteps 10 --seed 42``, once
as it is and once with ``--set optim.lowmem=true``; the gate is the JAX
script's, lowmem's best validation accuracy within 2 points of float32's
at equal epochs. Besides, it reads each arm's best checkpoint back and
records the dtypes of its optimizer moments and EMA (bfloat16 in the
lowmem arm, float32 in the other), and it exits 1 when the gate fails,
an arm prints no summary, or a state has the other arm's dtypes. The
arms run in this process through ``cli.main.main(argv)``.

    python -m ladine_tpu_torch.examples.lowmem_ab [--work _lowmem_ab] [--device cpu]

Writes ``--out`` (default ``{work}/lowmem_convergence_ab.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
from typing import Optional

from ladine_tpu_torch.device import card_line, resolve_device

GATE_POINTS = 2.0
WANT_DTYPES = {"fp32": "torch.float32", "lowmem": "torch.bfloat16"}


def summary_line(text: str) -> Optional[dict]:
    """The last line of ``text`` that is a JSON object: the CLI's summary."""
    last = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                last = json.loads(line)
            except json.JSONDecodeError:
                pass
    return last


def cli_arm(argv: list) -> tuple:
    """``cli.main.main(argv)`` in this process: (exit code, its stdout)."""
    from ladine_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main.main(argv)
    return rc, out.getvalue()


def state_dtypes(ckpt: str) -> dict:
    """The dtypes of a member checkpoint's Adam moments and EMA, read back
    from the checkpoint: {"mu": [...], "nu": [...], "ema": [...]}, each the
    sorted set of its leaves' dtypes."""
    from ladine_tpu_torch.utils.checkpoint import load_train_state

    states, _, _ = load_train_state(ckpt)
    groups = {slot: states.opt_state[slot] for slot in ("mu", "nu")}
    groups["ema"] = states.ema
    return {name: sorted({str(t.dtype) for t in leaves.values()}) for name, leaves in groups.items()}


def run_arm(work: str, name: str, epochs: int, extra: list, device: str) -> dict:
    argv = ["--device", device, "--demo", "--train", "--n_epochs", str(epochs), "--timesteps", "10",
            "--seed", "42", "--exp", os.path.join(work, name), "--doc", "ab", *extra]
    print(f"[lowmem_ab] cli.main {' '.join(argv)}", file=sys.stderr)
    rc, text = cli_arm(argv)
    last = summary_line(text)
    if rc != 0 or last is None:
        return {"rc": rc, "summary": None}
    ckpt = last.get("best_ckpt_path")
    return {"rc": rc, "summary": last, "state_dtypes": state_dtypes(ckpt) if ckpt else None}


def accuracy(r: dict) -> Optional[float]:
    s = r.get("summary") or {}
    return s.get("best_accuracy") or s.get("best_val_accuracy")


def verdict(arms: dict) -> tuple:
    """(gate passed, dtypes as expected, reasons it failed)."""
    why = []
    for name, r in arms.items():
        if r.get("summary") is None:
            why.append(f"the {name} arm printed no summary (rc {r.get('rc')})")
        elif r.get("state_dtypes") is None:
            why.append(f"the {name} arm saved no checkpoint")
        elif any(v != [WANT_DTYPES[name]] for v in r["state_dtypes"].values()):
            why.append(f"the {name} arm's state is {r['state_dtypes']}, not {WANT_DTYPES[name]}")
    a32, alow = accuracy(arms["fp32"]), accuracy(arms["lowmem"])
    gate = a32 is not None and alow is not None and alow >= a32 - GATE_POINTS
    if not gate:
        why.append(f"lowmem {alow} is not within {GATE_POINTS} points of fp32 {a32}")
    dtypes_ok = all(r.get("state_dtypes") and all(v == [WANT_DTYPES[n]] for v in r["state_dtypes"].values())
                    for n, r in arms.items())
    return gate, dtypes_ok, why


def run(work: str, epochs: int = 6, device="cuda", out: Optional[str] = None) -> dict:
    """Both arms into ``work``, each through :func:`cli_arm`; writes and
    returns the result."""
    dev = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    arms = {"fp32": run_arm(work, "fp32", epochs, [], dev.type),
            "lowmem": run_arm(work, "lowmem", epochs, ["--set", "optim.lowmem=true"], dev.type)}
    gate, dtypes_ok, why = verdict(arms)
    result = {
        "what": ("training-convergence A/B for optim.lowmem: demo config, identical seeds/data/epochs, fp32 "
                 "Adam+EMA vs bf16 state with stochastic rounding (train/lowmem.py), the PyTorch port"),
        "device": card_line(dev),
        "epochs": epochs,
        "fp32": arms["fp32"],
        "lowmem": arms["lowmem"],
        "val_acc_fp32": accuracy(arms["fp32"]),
        "val_acc_lowmem": accuracy(arms["lowmem"]),
        "gate": f"lowmem within {GATE_POINTS:g} acc points of fp32 at equal epochs",
        "pass": gate,
        "state_dtypes_as_expected": dtypes_ok,
        "failures": why,
    }
    out = out or os.path.join(work, "lowmem_convergence_ab.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="_lowmem_ab")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="the result JSON (default {work}/lowmem_convergence_ab.json)")
    args = ap.parse_args(argv)
    result = run(args.work, args.epochs, args.device, args.out)
    print(json.dumps({k: result[k] for k in ("val_acc_fp32", "val_acc_lowmem", "pass", "state_dtypes_as_expected",
                                             "failures")}))
    return 0 if result["pass"] and result["state_dtypes_as_expected"] else 1


if __name__ == "__main__":
    sys.exit(main())
