"""Serving launcher, on the card by default: either the Peregrine detection
service over a synthetic packet stream, or LM serving with batched
requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --attack mirai
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --n-train 4000 --n-eval 4000 --epoch 64 --n-slots 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --fc-mode switch \
      --device cpu --n-train 600 --n-eval 400 --epoch 16 --n-slots 256
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --no-reduced

``--mode detect`` trains on the benign prefix (``observe_stream`` +
``fit``), streams the eval window through ``process_stream``, and prints
one JSON line with the throughput, record and alarm counts, the attack AUC
and the kernels' launch counts; ``--fc-mode switch`` runs the switch's
arithmetic on the serial FC oracle (a Python loop over packets).
``--mode lm`` serves ``--requests`` random prompts of ``--prompt-len``
tokens through ``ServeEngine`` with random weights from ``--seed`` and
prints one JSON line with the tokens, prefill and decode times and the
launch counts.  ``--reduced`` (the default, as in
the JAX launcher) runs the config cut to CPU size; ``--no-reduced`` runs it
at full width.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.detection.metrics import auc
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import build_model
from repro_torch.models.lm_engine import Request, ServeEngine
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
            "fc_mode": svc.mode, "fc_backend": svc.backend,
            "train_pkts": args.n_train, "train_s": t_fit,
            "threshold": svc.threshold, "eval_pkts": n, "eval_s": dt,
            "eval_pps": n / dt, "records": int(len(scores)),
            "alarms": int(alarms.sum()), "auc": auc(scores, labels),
            "launches": launch_counts()}


def serve_lm(args) -> dict:
    cfg = reduce_cfg(get_arch(args.arch)) if args.reduced else get_arch(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init_params(args.seed)
    eng = ServeEngine(model, params, batch_slots=args.slots,
                      max_seq=args.max_seq, device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = torch.from_numpy(rng.integers(1, cfg.vocab, size=args.prompt_len))
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    reset_launch_counts()
    _sync(model.device)
    t0 = time.perf_counter()
    outputs = eng.run()
    _sync(model.device)
    dt = time.perf_counter() - t0
    st = eng.stats
    toks = sum(len(v) for v in outputs.values())
    return {"device": str(model.device), "arch": cfg.name,
            "params": cfg.param_count(), "slots": args.slots,
            "max_seq": args.max_seq, "prompt_len": args.prompt_len,
            "requests": len(outputs), "tokens": toks, "wall_s": dt,
            "tok_s": toks / dt, **st,
            "prefill_s_per_request": st["prefill_s"] / max(st["prefills"], 1),
            "decode_tok_s": st["decode_tokens"] / st["decode_s"] if st["decode_s"] else 0.0,
            "launches": launch_counts(), "outputs": outputs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("detect", "lm"), default="detect")
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
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    args = ap.parse_args()
    print(json.dumps(serve_detect(args) if args.mode == "detect" else serve_lm(args)))


if __name__ == "__main__":
    main()
