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
``--layers N`` keeps the first N layers, the depth cut a card's memory
may need at full width.
Any ``--arch`` trains on ``lm_batches``' token ids, as the JAX launcher
feeds every family (a model that takes embeddings, hubert, then trains
through ``embed``, its ``in_proj`` getting a zero gradient).

``--mesh DxM`` places the step over a (data D, model M) mesh as JAX's
launcher does: the rules from ``make_rules(cfg, ShapeConfig("cli", seq,
batch, "train"), model_size=M, dp_size=D)``, the parameter, optimizer
(ZeRO-1 as ``TrainConfig.zero1`` says; the launcher sets no flag for it)
and batch specs, and ``make_placed_train_step``.  The places are one card
each where D x M cards are visible and ``--device`` is a card, else
``--device`` repeated D x M times (``--device cpu --mesh 2x2`` runs four
places on the CPU).  Its checkpoints are the one-device layout, so they
restore on any mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import TrainConfig, get_arch, reduced as reduce_cfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import Prefetcher, lm_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import batch_specs, opt_specs, param_specs
from repro_torch.distributed.sharding import AxisRules, P, set_mesh, use_rules
from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
from repro_torch.models import build_model
from repro_torch.training import CheckpointManager, init_train_state, make_train_step
from repro_torch.training.fault import StragglerMonitor, resilient_loop
from repro_torch.training.train_step import make_placed_train_step


def parse_mesh(text: str):
    """"DxM" -> (D, M); raises ``ValueError`` on anything else."""
    parts = text.split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh takes DxM (data x model), e.g. 2x4; got {text!r}")
    return int(parts[0]), int(parts[1])


def mesh_devices(dev: torch.device, n: int):
    """A card a place where ``dev`` is a card and ``n`` cards are visible,
    else ``dev`` repeated ``n`` times."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def train_lm(args) -> dict:
    """One training run as the launcher's flags say; its result as a dict."""
    mesh_dm = parse_mesh(args.mesh) if args.mesh else None
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=dev)
    tc = TrainConfig(learning_rate=args.lr, remat=args.remat,
                     microbatches=args.microbatches,
                     warmup_steps=max(args.steps // 10, 1))
    state = init_train_state(model, tc, tc.seed)
    step_fn = make_train_step(model, tc)
    rules_d, mesh = None, None
    if mesh_dm is not None:
        d, m = mesh_dm
        mesh = make_host_mesh(d, m, devices=mesh_devices(dev, d * m))
        shp = ShapeConfig("cli", args.seq, args.batch, "train")
        rules_d = make_rules(cfg, shp, multi_pod=False, model_size=m, dp_size=d)
        rules = AxisRules(rules_d)
        ps = param_specs(state["params"], cfg, rules, m)
        os_ = opt_specs(state["opt"], ps, cfg, rules, mesh_shape_dict(mesh), tc.zero1)
        step_fn = make_placed_train_step(model, tc, mesh,
                                         {"params": ps, "opt": os_, "step": P()},
                                         batch_specs(cfg, shp, rules))
        state = step_fn.place_state(state)
    batches = [
        {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        for b in Prefetcher(lm_batches(cfg.vocab, args.batch, args.seq,
                                       args.steps, seed=tc.seed))]
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    mon = StragglerMonitor()
    t0 = time.time()
    with use_rules(rules_d), set_mesh(mesh):
        out = resilient_loop(step_fn, state, batches, ckpt,
                             ckpt_every=args.ckpt_every, monitor=mon)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    return {"device": str(dev), "arch": cfg.name, "steps": out["completed"],
            "restarts": out["restarts"], "stragglers": len(mon.stragglers),
            "loss": float(out["metrics"]["loss"]), "wall_s": dt,
            "tokens_per_s": toks / dt, "ckpt_steps": ckpt.all_steps(),
            "mesh": None if mesh is None else mesh_shape_dict(mesh)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (a depth cut to fit a card)")
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
