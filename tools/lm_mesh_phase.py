"""Phases ``lm_mesh`` and ``dryrun`` of ``chip_smoke.py`` alone, on one CUDA
card (or four).

    python3 tools/lm_mesh_phase.py

Builds the flash kernel (the placed prefill runs it on each place), then
runs ``chip_smoke.phase_lm_mesh``: the placed train step of gemma2-2b at
full width (``chip_smoke.LM_MESH_LAYERS`` layers) with the dense layers'
compute split over a 2x2 mesh of places on cuda:0 against the one-device
step, the dry run's meta peak of that step against the card's, the placed
prefill and decode against one device, ``moe_ffn_local`` at phi3.5-moe's
width, sequence-parallel decode at gemma2-2b's decode shape, a re-meshed
checkpoint and the launcher's ``--mesh 2x2``; with four cards also a card a
place; then the same step with the weights cut over the data places too
(FSDP), held the same way; then the hybrid (zamba2-2.7b at full width,
``chip_smoke.LM_MESH_HYBRID_LAYERS`` layers, its SSD split over the model
places): its placed step against one device and each place's growth against
the meta count, its placed prefill (flash per place, each launch held
against its plain version) and decode.  Then ``chip_smoke.phase_dryrun``: six
production cells on the meta device.  TF32 off, as in the full run.  The card's name and power limit
(nvidia-smi) come first; the records also go to ``lm_mesh_phase.json`` in
the output directory.  A failed check ends the run with a non-zero exit.
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
        print("lm_mesh_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels import FLASH_ATTENTION
    from repro_torch.kernels.build import build_all
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    build_all([FLASH_ATTENTION])
    log: list = []
    try:
        chip_smoke.phase_lm_mesh(log)
        chip_smoke.phase_dryrun(log)
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "lm_mesh_phase.json").write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
