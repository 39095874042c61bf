"""Compare 2D-vs-3D training convergence from log files (counterpart of
``scripts/analyze_convergence.py``).

    python -m pose_splatter_torch.scripts.analyze_convergence --log2d 2d.log
        --log3d 3d.log [--plot convergence.pdf] [--out summary.json]

The logs are what the train CLI prints (either package's). Host-only:
``--device`` is accepted, as on every CLI of the port, and its help says
that it is ignored. The plot needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import sys

from pose_splatter_torch.scripts.common import add_device
from pose_splatter_torch.utils.loganalysis import (
    convergence_summary,
    parse_training_log,
    plot_convergence_comparison,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--log2d", required=True)
    parser.add_argument("--log3d", required=True)
    parser.add_argument("--plot", default="convergence_comparison.pdf")
    parser.add_argument("--out", default=None)
    return add_device(parser, used=False)


def main(argv=None):
    args = build_parser().parse_args(argv)
    d2 = parse_training_log(args.log2d)
    d3 = parse_training_log(args.log3d)
    summary = convergence_summary(d2, d3)
    print(json.dumps(summary, indent=2))
    if args.plot:
        path = plot_convergence_comparison(d2, d3, save_path=args.plot)
        print(f"plot: {path}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
