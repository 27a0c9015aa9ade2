"""Quickstart on the PyTorch port: the whole Peregrine loop, on the card.

Synthesises a Mirai-style trace, trains the detector on the benign prefix,
then streams the attack window through the data-plane feature pipeline and
scores per-epoch records — §3.2's workflow end to end.  The service's
``observe_stream``/``process_stream`` chunk the trace with bounded memory
and carry flow-table state plus the global packet count across chunks.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card each chunk's features come from one ``fc_full`` launch and its
records' scores from one ``kitnet_score`` launch (fit's ensemble pass runs
``kitnet_ae``); ``--device cpu`` runs their plain PyTorch versions.  Swap
the FC data plane by name, e.g. the hash-partitioned flow tables:
``DetectionService(..., backend="sharded", shards=16)`` — and the MD
scoring stage the same way: ``md_backend="cuda"`` (the default) scores
through the hand-written kernel, ``md_backend="einsum"`` through plain
torch ops.  ``--n-train``, ``--n-benign-eval`` and ``--n-attack`` cut the
trace.
"""
import argparse
import subprocess

from repro_torch.detection.metrics import auc
from repro_torch.serving import DetectionService
from repro_torch.traffic import synth_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-train", type=int, default=12000)
    ap.add_argument("--n-benign-eval", type=int, default=6000)
    ap.add_argument("--n-attack", type=int, default=6000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a trace: benign training prefix + eval window with the attack mixed in
    data = synth_trace("mirai", n_train=args.n_train, n_benign_eval=args.n_benign_eval,
                       n_attack=args.n_attack, seed=0)

    # 2. the detector: per-packet FC on the device, one feature record every
    #    256 packets to the KitNET classifier — sampling AFTER features.
    svc = DetectionService(epoch=256, n_slots=8192, mode="exact", device=args.device)
    print(f"device: {svc.device}")
    if svc.device.type == "cuda":      # the card's name and power limit
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())

    # 3. training phase: benign traffic only (first 1M packets in the paper)
    svc.observe_stream(data["train"], chunk=4096)
    svc.fit(fpr=0.01)
    print(f"trained; alarm threshold RMSE={svc.threshold:.4f}")

    # 4. detection phase: stream the eval window. Record indices are global
    #    stream positions, so subtract the eval window's start offset to look up
    #    labels — chunking does not change which packets close an epoch.
    eval_start = svc.pkt_count
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=4096)
    labels = data["eval"]["label"][idx - eval_start]
    a = auc(scores, labels)

    print(f"{len(scores)} records scored, {int(alarms.sum())} alarms")
    print(f"attack-record AUC = {a:.3f}  (paper: >0.8 for 13/15 attacks)")
    return {"idx": idx, "scores": scores, "alarms": alarms, "auc": a,
            "threshold": svc.threshold}


if __name__ == "__main__":
    main()
