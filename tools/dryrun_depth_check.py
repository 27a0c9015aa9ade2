"""A dry-run cell continued from three depths against its run at full depth.

    python3 tools/dryrun_depth_check.py qwen2-vl-72b train_4k [--multi-pod]

``launch/dryrun.lower_cell`` runs a deep cell of alike stacked layers at
depths 2p, 3p and 4p and continues every count to the cell's depth
(``extrapolation_depths``).  This runs the cell that way and again at its
full depth, prints one JSON line with each run's largest place, place 0,
seconds and lowering, and whether the two records agree on every place's
peak and FLOPs and on the bytes and hand-overs by kind; it exits 1 where
they do not.  CPU only, on the meta device; a 72B train cell at full depth
takes minutes and a few GiB of host memory.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    continued = dryrun.lower_cell(args.arch, args.shape, args.multi_pod, check_flops=False)
    depths = dryrun.extrapolation_depths
    dryrun.extrapolation_depths = lambda cfg: None
    try:
        full = dryrun.lower_cell(args.arch, args.shape, args.multi_pod, check_flops=False)
    finally:
        dryrun.extrapolation_depths = depths
    keys = ("memory", "flops", "transfer_bytes", "transfers")
    differ = [k for k in keys if continued[k] != full[k]]
    print(json.dumps({
        "cell": f"{args.arch}__{args.shape}__{'multipod' if args.multi_pod else 'singlepod'}",
        **{name: {"peak_bytes_largest_place": r["memory"]["peak_bytes_largest_place"],
                  "peak_bytes_place0": r["memory"]["peak_bytes_place0"],
                  "largest_place": r["memory"]["largest_place"],
                  "cost_lowering": r["cost_lowering"], "seconds": r["seconds"]}
           for name, r in (("continued", continued), ("full_depth", full))},
        "equal": not differ, "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
