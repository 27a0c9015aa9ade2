"""LM serving engine: prefill + decode over a fixed-slot batch
(continuous-batching-lite).

A port of the JAX package's ``models/lm_engine.py``.  Free slots are
refilled by prefilling the incoming prompt alone and splicing its KV cache
into the batch cache at the slot index; each tick then decodes one greedy
token for every slot.  Carried over as the reference has it: one scalar
``pos`` is shared by all slots, and a splice takes the largest (so a slot
admitted later decodes from the furthest position, over cache rows it never
wrote), and inactive slots are decoded too.

The engine also sums what its users pay for: prefill and decode wall time
(each ends in a device sync, the token read back) and their token counts,
in ``stats``.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor          # (S,) integer token ids
    max_new: int = 32


class ServeEngine:
    def __init__(self, model: Model, params, batch_slots: int, max_seq: int,
                 cache_dtype=torch.bfloat16, device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"the model runs on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_seq = max_seq
        self.cache = model.init_cache(batch_slots, max_seq, cache_dtype)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.remaining = [0] * batch_slots
        self.outputs: Dict[int, List[int]] = {}
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.long,
                                  device=self.device)
        self.stats = {"prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0}

    def submit(self, req: Request) -> None:
        self.queue.put(req)

    def _admit(self) -> None:
        for slot in range(self.B):
            if self.active[slot] is None and not self.queue.empty():
                req = self.queue.get()
                # prefill the prompt for this slot alone, splice KV in
                t0 = time.perf_counter()
                prompt = torch.as_tensor(req.prompt, device=self.device)
                logits, _, cache1 = self.model.forward(
                    self.params, {"tokens": prompt[None]},
                    build_cache=True, max_seq=self.max_seq)
                self.cache = _splice_cache(self.cache, cache1, slot)
                tok = int(torch.argmax(logits[0, -1]))
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.stats["prefills"] += 1
                self.stats["prefill_tokens"] += int(prompt.shape[0])
                self.tokens[slot, 0] = tok
                self.active[slot] = req
                self.remaining[slot] = req.max_new - 1
                self.outputs[req.rid] = [tok]

    def step(self) -> int:
        """One engine tick: admit new requests, one decode step for all."""
        self._admit()
        if not any(self.active):
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(self.params, self.tokens,
                                                    self.cache)
        nxt = torch.argmax(logits[:, 0, :], dim=-1)
        self.tokens = nxt[:, None]
        nxt = nxt.tolist()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        live = 0
        for slot in range(self.B):
            req = self.active[slot]
            if req is None:
                continue
            self.outputs[req.rid].append(nxt[slot])
            self.stats["decode_tokens"] += 1
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0:
                self.active[slot] = None
            else:
                live += 1
        return live

    def run(self, max_ticks: int = 1000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            self._admit()
            if not any(self.active) and self.queue.empty():
                break
            self.step()
        return self.outputs


def _splice_cache(batch_cache: Dict, one_cache: Dict, slot: int) -> Dict:
    """Copy a single-request cache (batch 1) into slot ``slot`` of the batch
    cache, in place; the shared ``pos`` becomes the larger of the two."""
    for name, o in one_cache.items():
        b = batch_cache[name]
        if name == "pos":
            batch_cache[name] = max(b, o)
        elif b.shape == o.shape:
            b.copy_(o)
        else:                            # leading layer axis, then batch
            b[:, slot:slot + 1].copy_(o)
    return batch_cache
