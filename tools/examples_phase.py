"""Phases ``examples`` and ``train_long`` of ``chip_smoke.py`` alone, on one
CUDA card.

    python3 tools/examples_phase.py

Builds the kernels, runs the four examples as ``chip_smoke.py`` does (each
a script in a subprocess, held against the same run on the CPU), all at
their defaults: sampling_collapse on its 26,000 packets, where the smoke
run cuts it to 4,000.  Then phase ``train_long`` (gemma2-2b on one row of
4096 tokens, its step against the meta count, its gradients at 8 layers
against those of the plan that keeps the blocks' products).  The card's
name and power limit (nvidia-smi) come first; the records also go to
``chiprun_out/examples_phase.json``.  About 6 minutes on one H100
(sampling_collapse ~130 s on the card and as long again on the CPU); a
phase's failure ends the run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("examples_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.build import build_all
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    log: list = []
    try:
        t0 = time.perf_counter()
        build_all(KERNELS)
        chip_smoke.emit({"phase": "build", "seconds": time.perf_counter() - t0}, log)
        t0 = time.perf_counter()
        rec = chip_smoke.phase_examples(sampling_args=())
        rec["phase_s"] = time.perf_counter() - t0
        chip_smoke.emit(rec, log)
        chip_smoke.phase_train_long(log)
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "examples_phase.json").write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
