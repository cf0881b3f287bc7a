"""Rebuild ``evidence/RESULTS_torch.md`` from the per-row reports in
``evidence/torch/`` (``sync_evidence``): no card, no work directory. The
port's ``scripts/render_results.py``: every row whose report landed is in
the table, a missing row shows em dashes, and the JAX run's mv-acc and ECE
stand beside each row where ``evidence/report_<row>.json`` holds them.

    python -m ladine_tpu_torch.examples.render_results [--evidence evidence]
        [--reports DIR] [--reference DIR] [--out FILE]

``--evidence`` is an evidence directory, as in ``run_results`` and
``sync_evidence``: the port's reports in its ``torch/`` (``--reports``
overrides), the JAX run's beside them in it (``--reference`` overrides,
'' for none), the file written into it (``--out`` overrides).

Where ``results_summary.json`` landed beside the reports (``run_results``
writes it when its run completes), the file is ``run_results``' own, with
the stages, epochs and seconds; else the table shows what landed before a
run was cut.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

from ladine_tpu_torch.examples.run_results import CORRUPTION_ROWS, _read_json, md_row, uncertainty_lines

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = [
    ("full", "clean, full 1000-step chain (parity workload)"),
    ("d50", "clean, DDIM-50 eta=1 (serving sampler)"),
    ("ema", "clean, DDIM-50, EMA weights (--eval_ema)"),
    ("int8", "clean, DDIM-50, int8 eps matmuls (--int8)"),
    ("int8_enc", "clean, DDIM-10, int8 eps + int8 encode/heads (fast preset)"),
    ("int8_pallas", "clean, DDIM-10, fused Pallas int8 eps (opt-in, demoted)"),
    ("int8_pallas_v2", "clean, DDIM-10, fused Pallas int8 eps v2 (opt-in, demoted)"),
    ("d25", "clean, DDIM-25 eta=1 (step sweep)"),
    ("d10", "clean, DDIM-10 eta=1 (step sweep)"),
    ("noise", "corruption: gaussian noise 0.1"),
    ("noise_hard", "corruption: gaussian noise 0.2"),
    ("contrast", "corruption: contrast 0.6"),
    ("lowres", "corruption: down-up resample /2"),
    ("cover", "corruption: random cover 5% x4"),
    ("cover_fp32", "corruption: random cover 5% x4 (fp32 A/B)"),
    ("crop", "corruption: crop 10% + resize"),
    ("atk_fgsm", "attack: FGSM eps 0.03 (white-box ViT)"),
    ("atk_pgd", "attack: PGD eps 0.03 (white-box ViT)"),
]


def load_dir(directory: str) -> Dict[str, dict]:
    """``{name: report}`` of every ``report_<name>.json`` in ``directory``."""
    if not os.path.isdir(directory):
        return {}
    return {f[len("report_"):-len(".json")]: _read_json(os.path.join(directory, f))
            for f in sorted(os.listdir(directory)) if f.startswith("report_") and f.endswith(".json")}


def table_lines(reports: Dict[str, dict], reference: Optional[Dict[str, dict]] = None) -> list:
    """The calibration line, the table of :data:`ROWS` and the uncertainty
    separation of the clean and corrupted rows, from ``reports`` (``{name:
    report}``); ``reference`` (the JAX run's) adds its mv-acc and ECE."""
    calib, calib_ema = reports.get("calib"), reports.get("calib_ema")
    lines = []
    if calib:
        line = (f"- calibrated temperature (cached-sample Nelder-Mead): **{calib['calibrated_temperature']:.4f}** "
                f"(val ECE {calib['ece']:.4f})")
        if calib_ema:
            line += (f"; EMA-weights temperature fit separately: **{calib_ema['calibrated_temperature']:.4f}** "
                     f"(val ECE {calib_ema['ece']:.4f})")
        lines += [line, ""]
    head, rule = "| evaluation | acc % | mv-acc % | ECE | NLL | Brier |", "|---|---|---|---|---|---|"
    if reference is not None:
        head, rule = head + " JAX mv-acc % | JAX ECE |", rule + "---|---|"
    lines += [head, rule]
    for name, label in ROWS:
        if name == "ema" and calib_ema is not None:
            label += " (own temperature)"  # the EMA arm's temperature fit ran
        row = md_row(label, reports.get(name))
        if reference is not None:
            ref = reference.get(name)
            cells = ("—", "—") if ref is None else (f"{ref['majority_vote_accuracy']:.2f}", f"{ref['ece']:.4f}")
            row = row.rstrip("|").rstrip() + f" | {cells[0]} | {cells[1]} |"
        lines.append(row)
    lines.append("")
    lines += uncertainty_lines({label: r for name, label in ROWS
                                if name in ("full", "d50") + CORRUPTION_ROWS and (r := reports.get(name)) is not None})
    return lines


def render(evidence: str, reference: Optional[str] = None) -> str:
    """The markdown of the reports in ``evidence``: ``run_results``' own
    file where its ``results_summary.json`` landed there too, else the
    table with a header that says so."""
    reports = load_dir(evidence)
    ref = load_dir(reference) if reference else None
    summary = _read_json(os.path.join(evidence, "results_summary.json"))
    if summary is not None:
        from ladine_tpu_torch.examples.run_results import results_md

        return results_md(summary, reports, ref)
    present = [n for n, _ in ROWS if reports.get(n) is not None]
    lines = [
        "# RESULTS — the PyTorch port's evidence run (synthetic 224x224, parity dims)",
        "",
        f"> Rendered from the per-row reports in `{os.path.relpath(evidence, REPO)}`",
        "> (`python -m ladine_tpu_torch.examples.render_results`): `run_results` writes its own,",
        "> richer file only when every step completed.",
        "",
        "Parity dimensions (ViT-B/16 guidance, 5 mapping MLPs, 5 members with the 150528->4096",
        "encoder, T=1000, MC trials 20, test batch 70 drop_last) on the synthetic 2-class corpus",
        "(`ladine_tpu_torch/examples/make_synth_medical.py`).",
        "Reproduce: `python -m ladine_tpu_torch.examples.run_results --work <dir> --evidence evidence`.",
        "",
        *table_lines(reports, ref),
        "",
        f"Rows landed: {len(present)}/{len(ROWS)} ({', '.join(present) if present else 'none'}).",
        "A missing row (em dashes) did not complete; the run is resumable.",
    ]
    return "\n".join(lines) + "\n"


def write(evidence: str, reports: Optional[str] = None, reference: Optional[str] = None,
          out: Optional[str] = None) -> str:
    """:func:`render` the reports in ``reports`` (default ``{evidence}/torch``)
    beside the JAX run's in ``reference`` (default ``evidence``; '' for
    none) into ``out`` (default ``{evidence}/RESULTS_torch.md``); returns
    ``out``."""
    out = out or os.path.join(evidence, "RESULTS_torch.md")
    text = render(reports or os.path.join(evidence, "torch"), evidence if reference is None else reference or None)
    with open(out, "w") as f:
        f.write(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--evidence", default=os.path.join(REPO, "evidence"),
                    help="the evidence directory: the JAX run's report_*.json, the port's in its torch/")
    ap.add_argument("--reports", default=None, help="the port's report_*.json (default EVIDENCE/torch)")
    ap.add_argument("--reference", default=None,
                    help="the JAX run's report_*.json, beside each row (default EVIDENCE; '' for none)")
    ap.add_argument("--out", default=None, help="default EVIDENCE/RESULTS_torch.md")
    args = ap.parse_args(argv)
    print(f"wrote {write(args.evidence, args.reports, args.reference, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
