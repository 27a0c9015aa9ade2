"""A/B of the port's detection services (dense and Count-Min sketch state)
between checkouts, on one CUDA card.

    python3 tools/ab_service.py PARENT/src src src PARENT/src

Each argument is a checkout's ``src/`` directory.  Each runs in a process
of its own (both packages are ``repro_torch``), in the order given, builds
the service's kernels into its own checkout's ``build/``, and prints one
JSON line: for the dense service at its defaults and the sketch service
(``n_slots=4096``, ``rows=2``), ``observe_stream`` + ``fit`` over 262,144
benign packets of ``synth_trace("mirai", seed=0)``, then four untraced
passes of ``process_stream(chunk=8192)`` over its 262,144 eval packets:
each pass's eval packets a second (host clock around work that ends in
``torch.cuda.synchronize()``) and the first pass's AUC.  The card's name
and power limit (nvidia-smi) come first.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time


def one(src: str) -> dict:
    import torch
    sys.path.insert(0, src)
    from repro_torch.detection.metrics import auc
    from repro_torch.kernels import FC_FULL, KITNET_AE, KITNET_SCORE, SKETCH_UPDATE
    from repro_torch.kernels.build import build_all
    from repro_torch.serving import DetectionService
    from repro_torch.traffic import synth_trace
    build_all((FC_FULL, KITNET_AE, KITNET_SCORE, SKETCH_UPDATE))
    n = 262_144
    data = synth_trace("mirai", n_train=n, n_benign_eval=n // 2, n_attack=n // 2, seed=0)
    out = {"src": src}
    for name, kw in (("dense", {}),
                     ("sketch", {"state_backend": "sketch", "n_slots": 4096,
                                 "state_kw": {"rows": 2}})):
        svc = DetectionService(**kw)
        svc.observe_stream(data["train"], chunk=8192)
        svc.fit(seed=0, fpr=0.01)
        start = svc.pkt_count
        pps, first = [], None
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = svc.process_stream(data["eval"], chunk=8192)
            torch.cuda.synchronize()
            pps.append(n / (time.perf_counter() - t0))
            first = res if first is None else first
        idx, scores, _ = first
        out[name] = {"eval_pps": pps,
                     "auc": auc(scores, data["eval"]["label"][idx - start])}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2])))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for src in sys.argv[1:]:
        run = subprocess.run([sys.executable, __file__, "--one", src],
                             capture_output=True, text=True)
        if run.returncode:
            sys.stderr.write(run.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
