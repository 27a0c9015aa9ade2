"""Phase ``mesh`` of ``chip_smoke.py`` alone, on the cards of one host.

    python3 tools/mesh_phase.py

Builds what the phase holds its placed runs against as the full smoke run
does (the main traffic, 262,144 + 262,144 packets of ``synth_trace("mirai",
seed=0)``; the dense, sketch and bucketed S=4 and 16 services fitted on it,
each bucketed service's post-fit tables and unplaced eval; phase switch's
2,048 packets through the card's serial oracle), then runs
``chip_smoke.phase_mesh``: four places on cuda:0, and one place a card when
the host has two or more.  The card's name and power limit (nvidia-smi)
come first; the records also go to ``chiprun_out/mesh_phase.json``.  A
failed check ends the run with a non-zero exit.
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
        print("mesh_phase: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.core import clone_state, compute_features, init_state
    from repro_torch.serving import DetectionService
    from repro_torch.traffic import synth_trace, to_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    n = 262_144
    data = synth_trace("mirai", n_train=n, n_benign_eval=n // 2, n_attack=n // 2,
                       seed=0)

    def fitted(**kw):
        svc = DetectionService(device=dev, **kw)
        svc.observe_stream(data["train"], chunk=8192)
        svc.fit(seed=0, fpr=0.01)
        return svc

    svc = fitted()
    sketch = fitted(state_backend="sketch", n_slots=4096, state_kw={"rows": 2})
    part = {"bucketed": {}}
    for S in (4, 16):
        b = fitted(backend="bucketed", buckets=S)
        snap, count = clone_state(b.state), b.pkt_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = b.process_stream(data["eval"], chunk=8192)
        torch.cuda.synchronize()
        part["bucketed"][S] = {"svc": b, "snap": snap, "count": count, "result": result,
                               "eval_pps": len(data["eval"]["ts"]) / (time.perf_counter() - t0)}
    switch_tr = synth_trace("mirai", n_train=64, n_benign_eval=1024, n_attack=1024,
                            seed=0)["eval"]
    pk = to_torch(switch_tr, dev)
    part["serial"] = compute_features(init_state(8192, device=dev), pk, backend="serial")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_features(init_state(8192, device=dev), pk, backend="sharded", shards=4)
    torch.cuda.synchronize()
    part["sharded_4_ms_per_packet"] = (time.perf_counter() - t0) / len(switch_tr["ts"]) * 1e3
    log: list = []
    try:
        chip_smoke.phase_mesh(dev, data, svc, sketch, part, switch_tr, log)
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "mesh_phase.json").write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
