"""End-to-end training driver on the PyTorch port: train an LM for a few
hundred steps with the full production loop — prefetching data pipeline,
AdamW + warmup schedule, remat, checkpointing every 25 steps, straggler
monitoring, and auto-resume (kill it mid-run and start again: it continues
from the latest checkpoint).

Default is a reduced xlstm-125m-family config on the card;
``--arch gemma2-2b --no-reduced`` runs the real config (full width needs
the card's memory).

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 50

The train step runs plain torch on every device (no kernel of the port
has a backward).  ``--ckpt-dir`` defaults to ``repro_example_ckpt`` under
the temporary directory.
"""
import argparse
import os
import subprocess
import tempfile
import time

import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import CheckpointManager, init_train_state, make_train_step
from repro_torch.training.fault import StragglerMonitor


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_example_ckpt"))
    ap.add_argument("--no-reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch) if args.no_reduced else reduced(get_arch(args.arch))
    model = build_model(cfg, device=dev)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=20, remat="dots")
    print(f"device: {dev}")
    if dev.type == "cuda":      # the card's name and power limit
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M")

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    state = init_train_state(model, tc, 0)
    start = 0
    if ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"resumed from checkpoint at step {start}")

    step_fn = make_train_step(model, tc)
    mon = StragglerMonitor(threshold=4.0)
    data = Prefetcher(lm_batches(cfg.vocab, args.batch, args.seq,
                                 args.steps, seed=0), depth=2)

    t0 = time.time()
    metrics = None
    for i, b in enumerate(data):
        if i < start:
            continue
        ts = time.time()
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                         for k, v in b.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mon.record(i, time.time() - ts)
        if (i + 1) % 25 == 0:
            ckpt.save_async(i + 1, state)
            print(f"step {i + 1:4d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f}")
    ckpt.wait()
    ckpt.save(args.steps, state)
    toks = (args.steps - start) * args.batch * args.seq
    tok_s = toks / (time.time() - t0)
    loss = float(metrics["loss"]) if metrics is not None else float("nan")
    print(f"done: {tok_s:.0f} tokens/s on {dev}, "
          f"{len(mon.stragglers)} straggler steps, final loss {loss:.4f}")
    return {"state": state, "start": start, "loss": loss, "tokens_per_s": tok_s}


if __name__ == "__main__":
    main()
