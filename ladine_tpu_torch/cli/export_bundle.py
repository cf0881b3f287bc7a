"""Export an AOT serving bundle from a saved predictor artifact.

    python -m ladine_tpu_torch.cli.export_bundle \
        --artifact ./predictor_artifact --out ./bundle \
        --preset fast --max_batch 70

Counterpart of ``ladine_tpu/cli/export_bundle.py``: writes one
``torch.export`` program per ``MicroBatcher`` bucket up to ``--max_batch``
(or the explicit ``--batch_sizes``) plus the run weights, as
``Predictor.export_serving`` does. The bundle is locked to the device type
it is exported on: export on the card you serve on (``--device cuda``, the
default); ``--device cpu`` exports a bundle for the CPU, for local tests.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifact", type=str, required=True, help="a Predictor.save directory")
    ap.add_argument("--out", type=str, required=True, help="bundle directory")
    ap.add_argument("--preset", type=str, default=None, choices=["parity", "serving", "fast"],
                    help="operating point to bake into the exported program")
    ap.add_argument("--dtype", type=str, default="artifact", choices=["artifact", "bfloat16", "float32"],
                    help="compute dtype of the exported program")
    ap.add_argument("--max_batch", type=int, default=70,
                    help="export every MicroBatcher bucket up to this cap")
    ap.add_argument("--batch_sizes", type=int, nargs="*", default=None,
                    help="explicit batch sizes (overrides --max_batch)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device type the bundle is exported on, and runs on")
    args = ap.parse_args(argv)

    from ladine_tpu_torch.infer.batching import MicroBatcher
    from ladine_tpu_torch.infer.serve import Predictor

    sizes = tuple(args.batch_sizes) if args.batch_sizes else tuple(MicroBatcher.bucket_sizes(args.max_batch))
    predictor = Predictor.load(args.artifact, preset=args.preset, dtype=args.dtype, device=args.device)
    seconds = predictor.export_serving(args.out, batch_sizes=sizes)
    print(f"exported {len(sizes)} programs (batch sizes {list(sizes)}, device {predictor.device}, "
          f"{sum(seconds.values()):.1f} s) -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
