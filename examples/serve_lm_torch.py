"""Serve a small LM with batched requests through the continuous-batching
engine of the PyTorch port, on the card (the decode path the decode_32k
dry-run cells lower).

  PYTHONPATH=src python examples/serve_lm_torch.py --requests 6 --slots 3
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Each admitted prompt is prefilled alone through the ``flash_attention``
kernel on the card (its plain version on the CPU); decode runs plain torch
on every device, as the JAX package computes it.
"""
import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model
from repro_torch.models.lm_engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    model = build_model(cfg, device=args.device)
    # the weights of seed 0 drawn on the host, so that every device serves
    # the same model (a card's generator draws other numbers from a seed)
    params = build_model(cfg, device="cpu").init_params(0).to(model.device)
    engine = ServeEngine(model, params, batch_slots=args.slots, max_seq=128,
                         device=args.device)
    print(f"device: {engine.device}")
    if engine.device.type == "cuda":      # the card's name and power limit
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=torch.as_tensor(rng.integers(1, cfg.vocab, 16), dtype=torch.int32),
            max_new=args.max_new))

    t0 = time.time()
    outputs = engine.run()
    dt = time.time() - t0
    total = sum(len(v) for v in outputs.values())
    for rid in sorted(outputs):
        print(f"request {rid}: {outputs[rid]}")
    print(f"{len(outputs)} requests, {total} tokens, {total / dt:.1f} tok/s "
          f"({engine.device}, {args.slots} slots)")
    return {"outputs": outputs, "tok_s": total / dt}


if __name__ == "__main__":
    main()
