"""A/B of the port's KitNET ensemble kernel (``kitnet_ensemble``) between
checkouts, on one CUDA card.

    python3 tools/ab_kitnet_ae.py PARENT/src src src PARENT/src

Each argument is a checkout's ``src/`` directory.  Each runs in a process
of its own (both packages are ``repro_torch``), in the order given, builds
its kernel into its own checkout's ``build/``, and prints one JSON line:
per shape, the kernel's device time a launch from torch.profiler (every
device kernel whose name holds ``kitnet_ae_kernel``) over 200 back-to-back
calls after a warm-up, and its largest difference from the plain version.
The shapes: the service's net (k=14 AEs, m=10, h=8) at 8 records, fit's
256 and 8192; k=7 AEs of m = h = 33 at 8192; of m = h = 64 at 256 and
8192.  Inputs are the same in every process (numpy, seed 0).  The card's
name and power limit (nvidia-smi) come first.
"""
from __future__ import annotations

import json
import subprocess
import sys

SHAPES = [(14, 10, 8, 8), (14, 10, 8, 256), (14, 10, 8, 8192), (7, 33, 33, 8192),
          (7, 64, 64, 256), (7, 64, 64, 8192)]


def one(src: str) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, src)
    from repro_torch.kernels.kitnet_ae import kitnet_ensemble, kitnet_ensemble_ref
    out = {"src": src}
    for k, m, h, B in SHAPES:
        rng = np.random.default_rng(0)
        arrays = [rng.uniform(0.0, 1.2, (B, k, m)), rng.normal(0, 0.3, (k, m, h)),
                  rng.normal(0, 0.1, (k, h)), rng.normal(0, 0.3, (k, h, m)),
                  rng.normal(0, 0.1, (k, m)), (rng.random((k, m)) > 0.2) * 1.0]
        x, *net = (torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays)
        err = float((kitnet_ensemble(x, *net) - kitnet_ensemble_ref(x, *net)).abs().max())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                kitnet_ensemble(x, *net)
            torch.cuda.synchronize()
        hits = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "kitnet_ae_kernel" in e.key]
        out[f"k{k}_m{m}_h{h}_B{B}"] = {
            "ms": sum(us for us, _ in hits) / max(sum(c for _, c in hits), 1) * 1e-3,
            "max_abs_err": err}
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
