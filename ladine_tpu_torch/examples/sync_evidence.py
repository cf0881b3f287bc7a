"""Copy the reports of a ``run_results`` work directory into
``evidence/torch/`` under the repository's canonical names: the port's
``scripts/sync_evidence.py``, which writes ``evidence/`` itself (the JAX
run's files); this one never writes outside ``evidence/torch/``.

    python -m ladine_tpu_torch.examples.sync_evidence [--work _results_run] [--dry_run]

:func:`sync`'s ``evidence`` is an evidence directory (the JAX run's
reports), as ``--evidence`` is in ``run_results`` and ``render_results``;
the copies go into its ``torch/``.

Copies (the files that exist; prints what it did):
  exp/logs/calib/report.json                 -> evidence/torch/report_calib.json
  exp/logs/calib_ema/report.json             -> evidence/torch/report_calib_ema.json
  exp/logs/test_ema/report.json              -> evidence/torch/report_ema.json
  exp/logs/suite_fp32/report_cover_fp32.json -> evidence/torch/report_cover_fp32.json
  results_summary.json                       -> evidence/torch/results_summary.json
  exp/logs/suite/report_<row>.json           -> evidence/torch/report_<row>.json
  exp/logs/suite/*.png                       -> evidence/torch/<name>.png

A report that is not valid JSON (a write cut short) is not copied; the
others are, and then the sync raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
from typing import List, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVIDENCE = os.path.join(REPO, "evidence")


def pairs(work: str) -> List[Tuple[str, str]]:
    """(source in ``work``, canonical name) of every report a run writes,
    whether it exists or not, then the suite's reports and plots found."""
    logs = os.path.join(work, "exp", "logs")
    out = [
        (os.path.join(logs, "calib", "report.json"), "report_calib.json"),
        (os.path.join(logs, "calib_ema", "report.json"), "report_calib_ema.json"),
        (os.path.join(logs, "test_ema", "report.json"), "report_ema.json"),
        (os.path.join(logs, "suite_fp32", "report_cover_fp32.json"), "report_cover_fp32.json"),
        (os.path.join(work, "results_summary.json"), "results_summary.json"),
    ]
    for pattern in ("report_*.json", "*.png"):
        out += [(p, os.path.basename(p)) for p in sorted(glob.glob(os.path.join(logs, "suite", pattern)))]
    return out


def sync(work: str, dry_run: bool = False, evidence: str = EVIDENCE) -> List[str]:
    """Copy into ``{evidence}/torch``; returns the names copied."""
    dest = os.path.join(evidence, "torch")
    copied, bad = [], []
    for src, name in pairs(work):
        if not os.path.exists(src):
            continue
        if name.endswith(".json"):
            try:
                with open(src) as f:
                    json.load(f)
            except ValueError:
                bad.append(src)
                print(f"SKIPPED truncated/invalid JSON: {src}")
                continue
        if not dry_run:
            os.makedirs(dest, exist_ok=True)
            shutil.copyfile(src, os.path.join(dest, name))
        copied.append(name)
        print(f"{'would copy' if dry_run else 'copied'} {src} -> {os.path.join(dest, name)}")
    if not copied and not bad:
        print(f"nothing to sync from {os.path.join(work, 'exp', 'logs')}")
    if bad:
        # after the good files: a report cut short costs that report, not the sync
        raise RuntimeError(f"invalid report JSON (not synced): {bad}")
    return copied


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default="_results_run")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)
    sync(args.work, args.dry_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
