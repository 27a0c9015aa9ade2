"""Checkpointing: atomic, async-capable, restorable by either package.

A port of the JAX package's ``training/checkpoint.py`` with the same
on-disk layout.  Per step:  <dir>/step_<n>/
    manifest.json   — the leaves' key paths, shapes, dtypes, step
    arrays.npz      — all leaves as host arrays
    COMMIT          — written last; a checkpoint without it is invalid

The state is saved as the JAX package's tree under its key paths
(``opt/m/layers/attn/wq``, ``step``, ...), so a checkpoint written by
either package restores in the other.  Atomicity: everything is written
into ``<dir>/.tmp_step_<n>`` and ``os.replace``d into place, so a crash
mid-save never corrupts the latest valid checkpoint.  ``save_async``
copies every leaf to the host before it returns (a train step updates the
state in place) and writes on a worker thread.

A state placed over a mesh (``distributed.sharding.Placed`` leaves) is
gathered to the host when it is saved, so its checkpoint is the same file;
``restore(..., shardings=)`` cuts each leaf for the mesh its sharding names,
which may differ from the mesh it was saved on (JAX's elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.distributed.sharding import Placed, gather, place


def _host_copies(state):
    """Key paths and a host copy of every leaf (bfloat16 as float32, which
    numpy cannot hold)."""
    def host(t):
        if isinstance(t, Placed):
            t = gather(t, "cpu", dst=None)
        t = torch.as_tensor(t).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    return tree.key_paths(state), [host(t) for t in tree.leaves(state)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state) -> str:
        return self._write(step, *_host_copies(state))

    def save_async(self, step: int, state) -> None:
        self.wait()
        keys, host = _host_copies(state)      # snapshot before the write
        self._thread = threading.Thread(
            target=self._write, args=(step, keys, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, keys: List[str], host: List[np.ndarray]) -> str:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step, "time": time.time(),
            "keys": keys,
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target, step: Optional[int] = None, shardings=None):
        """Restore into the structure of ``target`` (a state tree of tensors
        or ``Placed`` leaves): new leaves with each target leaf's shape and
        dtype, on its device.  ``shardings``: a matching tree of
        ``NamedSharding`` (or ``None``) leaves, the mesh to place each leaf
        on; by default a ``Placed`` target leaf's own.  Returns (state,
        step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        data = np.load(os.path.join(path, "arrays.npz"))
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}
        leaves = tree.leaves(target)
        shs = (tree.leaves(shardings) if shardings is not None
               else [t.sharding if isinstance(t, Placed) else None for t in leaves])
        if len(shs) != len(leaves):
            raise ValueError(f"{len(shs)} shardings for {len(leaves)} leaves")
        out = []
        for k, tgt, sh in zip(tree.key_paths(target), leaves, shs):
            arr = by_key[k]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"checkpoint leaf {k} has shape {arr.shape}, "
                                 f"the target {tuple(tgt.shape)}")
            t = torch.from_numpy(arr).to(tgt.dtype)
            out.append(place(t, sh, src=None) if sh is not None
                       else t.to(tgt.device))
        return tree.unflatten(target, out), step
