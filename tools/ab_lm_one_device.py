"""A/B of the port's one-device LM serving and training between checkouts,
on one CUDA card.

    python3 tools/ab_lm_one_device.py PARENT . . PARENT

Each argument is a checkout's root.  Each runs in a process of its own (the
packages are all ``repro_torch``), in the order given: it builds the flash
kernel into its own checkout's ``build/`` and calls that checkout's
``chip_smoke.phase_lm_main`` (full-width gemma2-2b served for the
launcher's traffic and for four 8192-token prompts) and
``phase_train_main`` (ten AdamW steps of batch 8 x 128), TF32 off as in the
full run.  It prints one JSON line: decode ms a step and prefill seconds of
each traffic, and the training step's seconds and their median over steps
3-10.  The card's name and power limit (nvidia-smi) come first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def one(root: str) -> dict:
    import torch
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke
    from repro_torch.kernels import FLASH_ATTENTION
    from repro_torch.kernels.build import build_all
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all([FLASH_ATTENTION])
    log: list = []
    t0 = time.perf_counter()
    chip_smoke.phase_lm_main(log)
    chip_smoke.phase_train_main(log)
    out = {"root": root, "seconds": time.perf_counter() - t0}
    for r in log:
        if r.get("phase") == "lm_main":
            out[f"decode_ms_a_step_{r['traffic']}"] = 1e3 * r["decode_s"] / r["decode_steps"]
            out[f"prefill_s_{r['traffic']}"] = r["prefill_s"]
        elif r.get("phase") == "train_main":
            out["train_step_s"] = r["step_s"]
            out["train_step_s_median_3_10"] = r["step_s_median_3_10"]
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"root"')]
        if proc.returncode or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
