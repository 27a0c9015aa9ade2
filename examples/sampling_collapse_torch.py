"""Reproduce Figure 1 in miniature on the PyTorch port: the baseline
detector collapses under packet sampling while Peregrine's record sampling
holds.

  PYTHONPATH=src python examples/sampling_collapse_torch.py
  PYTHONPATH=src python examples/sampling_collapse_torch.py --device cpu \\
      --n-train 2000 --n-benign-eval 1000 --n-attack 1000

Peregrine's features run the switch's arithmetic on the serial FC oracle
(a loop over packets, on the device); the Kitsune baseline's exact
features of its sampled packets go through the ``fc_full`` kernel on the
card, and both systems score through ``kitnet_score``.  ``--n-train``,
``--n-benign-eval`` and ``--n-attack`` cut the trace.
"""
import argparse
import subprocess

from repro_torch.detection.sweep import sweep_attack
from repro_torch.device import resolve_device
from repro_torch.traffic import synth_trace

RATES = (1, 64, 256)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-train", type=int, default=10000)
    ap.add_argument("--n-benign-eval", type=int, default=8000)
    ap.add_argument("--n-attack", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    if dev.type == "cuda":      # the card's name and power limit
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())

    data = synth_trace("ssdp_flood", n_train=args.n_train,
                       n_benign_eval=args.n_benign_eval, n_attack=args.n_attack, seed=0)
    res = sweep_attack(data, rates=RATES, mode="switch", device=dev)

    print(f"{'rate':>8s} {'Peregrine AUC':>14s} {'Kitsune AUC':>12s}")
    for rate in RATES:
        p = res["peregrine"][rate]["auc"]
        k = res["kitsune"][rate]["auc"]
        print(f"1:{rate:<6d} {p:14.3f} {k:12.3f}")
    print("\nPeregrine samples feature RECORDS (after per-packet FC); the "
          "baseline samples raw packets before FC — Figure 3's distinction.")
    return res


if __name__ == "__main__":
    main()
