"""The LM training phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/train_phases.py

Runs phases ``train_main`` (full-width gemma2-2b, 10 AdamW steps of batch
8 x 128 in bf16 compute), ``train_reference`` (reduced gemma2-2b on the
card against the CPU), ``train_resume`` (the launcher and the fault loop),
``train_families`` (the families beyond dense at full width, 6 steps each)
and ``train_families_reference`` (the six non-dense archs reduced on the
card against the CPU), each printing its JSON line as in the full smoke run,
with TF32 off as there; the card's name and power limit (nvidia-smi) come
first, and the records also go to ``chiprun_out/train_phases.json``.  About
100 s and 52 GiB of device memory; a phase's failure ends the run.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    log: list = []
    try:
        for phase in (chip_smoke.phase_train_main, chip_smoke.phase_train_reference,
                      chip_smoke.phase_train_resume, chip_smoke.phase_train_families,
                      chip_smoke.phase_train_families_reference):
            phase(log)
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "train_phases.json").write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
