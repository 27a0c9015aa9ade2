"""Training launcher, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 50 --batch 8 --seq 128 --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 10 --batch 8 --seq 128

Builds the train state from ``TrainConfig(seed=0)``, feeds ``lm_batches``
through a ``Prefetcher`` and runs ``resilient_loop`` with a checkpoint
every ``--ckpt-every`` steps into ``--ckpt-dir`` (under the temporary
directory by default), then prints the JAX launcher's result line.
``--reduced`` runs the config cut to CPU size; without it, full width.
``--mesh`` (data x model placement over several devices) is not ported,
nor the training of a family other than dense (ROADMAP queue 1 item 12h).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import TrainConfig, get_arch, reduced as reduce_cfg
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import CheckpointManager, init_train_state, make_train_step
from repro_torch.training.fault import StragglerMonitor, resilient_loop
from repro_torch.training.train_step import require_dense


def train_lm(args) -> dict:
    """One training run as the launcher's flags say; its result as a dict."""
    if args.mesh:
        raise NotImplementedError(
            "--mesh (data x model placement over several devices) is not "
            "ported: ROADMAP queue 1 items 10c and 12g")
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    require_dense(cfg)
    model = build_model(cfg, device=dev)
    tc = TrainConfig(learning_rate=args.lr, remat=args.remat,
                     microbatches=args.microbatches,
                     warmup_steps=max(args.steps // 10, 1))
    state = init_train_state(model, tc, tc.seed)
    step_fn = make_train_step(model, tc)
    batches = [
        {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        for b in Prefetcher(lm_batches(cfg.vocab, args.batch, args.seq,
                                       args.steps, seed=tc.seed))]
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    mon = StragglerMonitor()
    t0 = time.time()
    out = resilient_loop(step_fn, state, batches, ckpt,
                         ckpt_every=args.ckpt_every, monitor=mon)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    return {"device": str(dev), "arch": cfg.name, "steps": out["completed"],
            "restarts": out["restarts"], "stragglers": len(mon.stragglers),
            "loss": float(out["metrics"]["loss"]), "wall_s": dt,
            "tokens_per_s": toks / dt, "ckpt_steps": ckpt.all_steps()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    rec = train_lm(parser().parse_args(argv))
    print(f"steps={rec['steps']} restarts={rec['restarts']} "
          f"stragglers={rec['stragglers']} "
          f"loss={rec['loss']:.4f} "
          f"tokens/s={rec['tokens_per_s']:.0f}")


if __name__ == "__main__":
    main()
