"""Detection launcher: the Peregrine detection service over a synthetic
packet stream, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --attack mirai
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --n-train 4000 --n-eval 4000 --epoch 64 --n-slots 1024

Trains on the benign prefix (``observe_stream`` + ``fit``), streams the
eval window through ``process_stream``, and prints one JSON line with the
throughput, record and alarm counts, the attack AUC and, on the card, the
kernels' launch counts.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.detection.metrics import auc
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.serving import DetectionService
from repro_torch.traffic import synth_trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_detect(args) -> dict:
    data = synth_trace(args.attack, n_train=args.n_train,
                       n_benign_eval=args.n_eval // 2,
                       n_attack=args.n_eval // 2, seed=args.seed)
    svc = DetectionService(epoch=args.epoch, n_slots=args.n_slots,
                           mode=args.fc_mode, device=args.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    svc.observe_stream(data["train"], chunk=args.chunk)
    svc.fit(seed=args.seed, fpr=args.fpr)
    _sync(svc.device)
    t_fit = time.perf_counter() - t0
    eval_start = svc.pkt_count
    t0 = time.perf_counter()
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=args.chunk)
    _sync(svc.device)
    dt = time.perf_counter() - t0
    labels = data["eval"]["label"][idx - eval_start]
    n = len(data["eval"]["ts"])
    return {"device": str(svc.device), "attack": args.attack,
            "train_pkts": args.n_train, "train_s": t_fit,
            "threshold": svc.threshold, "eval_pkts": n, "eval_s": dt,
            "eval_pps": n / dt, "records": int(len(scores)),
            "alarms": int(alarms.sum()), "auc": auc(scores, labels),
            "launches": launch_counts()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attack", default="mirai")
    ap.add_argument("--epoch", type=int, default=1024)
    ap.add_argument("--n-slots", type=int, default=8192)
    ap.add_argument("--fc-mode", default="exact", choices=("exact", "switch"))
    ap.add_argument("--n-train", type=int, default=20000)
    ap.add_argument("--n-eval", type=int, default=20000)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--fpr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    print(json.dumps(serve_detect(ap.parse_args())))


if __name__ == "__main__":
    main()
