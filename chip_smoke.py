"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; a failure raises and ends the run):
  1. device  — the card's name, and its name and power limit from nvidia-smi.
  2. build   — nvcc builds every kernel of the port from
               src/repro_torch/csrc/ into build/, all sources in parallel;
               for each flash instantiation, ptxas's registers and spills,
               its shared memory, and its HGMMA/HMMA/FFMA counts (cuobjdump).
  flash   — the flash-attention kernel against its plain version on the
               card: the JAX package's test shapes (tests/test_kernels.py,
               f32 to 2e-6, bf16 to 2e-2, the window/softcap cases), and
               gemma2-2b's prefill attention at B=1, H=8, K=4, S=8192,
               D=256, softcap 50, window 4096 and global, in f32 (2e-5) and
               bf16 (1e-5 + 2**-7 * |want|, one bf16 ulp); kernel, plain
               and scaled_dot_product_attention times in both dtypes (the
               library yardstick: no softcap, no window; the faster of the
               GQA call and the call on kv heads repeated beforehand).  The
               f32 bound is at the split-TF32 rate the kernel computes at.
  3. fc      — the FC kernels (scan, prelude, chain, residual, SR chain,
               features) against their plain version (core/pipeline.py's
               serial oracle, run on the card) on one 8192-packet chunk at
               n_slots=8192, features and every table bit for bit, chunked
               carry bit for bit, and an 8192-packet chunk of one flow bit
               for bit; kernel (each of the six apart), plain and one-flow
               times, the longest segment and the chain floor (the longest
               segment times one dependent multiply-add, measured here).
  sketch  — the sketch kernels (schedule, update, features) against their
               plain version (core/sketch.py's process_sketch, run on the
               card), features and every table bit for bit, and the card's
               schedule equal to its twin (sketch_schedule_ref): at the
               sketch main path's W=4096, R=2 on the second 8192-packet
               chunk of a mirai stream (from the state the first chunk
               left), on a 4096-packet chunk at W=64, R=4 with
               evict_age=0.5 (rows collide, cells age out) and on an
               8192-packet chunk of one flow; chunked carry == one shot
               bit for bit; at R=1, W=8192 its state equals phase fc's
               dense kernel state bit for bit.  Per key type the deepest
               level and the rounds; schedule, update and features times
               apart on the W=4096, R=2 chunk, on it replayed and on the
               single flow; the chain floor (deepest level times one dependent
               L2 round trip, measured here); ptxas's record of each
               instantiation.
  fc_single — the single-key kernels' entry point driven once with the
               launch counts zeroed (its path), then against their plain
               version at n=8192, n_slots=8192 bit for bit, chunked == one
               shot bit for bit, and all 8192 packets in one slot bit for
               bit; times (each of the three kernels apart) on mirai's
               slots, on uniform slots and on the one slot, the longest
               run and its chain floor.
  limits  — each shape the kernels took only since this slice, on the card
               against its plain version: sketch rows 9 and 16 at W=64 bit
               for bit (and the schedule against its twin); AE widths 33
               and 64 (<=1e-5, chunked == one shot); flash head dims 80
               and 112 in f32 and bf16 (zero-padded; 2e-6 and 2e-2); prefill
               positions arange(S) + 5 through a gemma2 model with the flash
               kernel against the plain route (2e-5).
  4. main    — the detection service at its defaults (n_slots=8192,
               epoch=1024, 80 features, max_size=10): observe_stream over
               262,144 benign packets, fit, process_stream(chunk=8192) over
               262,144 eval packets of synth_trace("mirai", seed=0); launch
               counts are zeroed just before and read just after: fc_full
               must have launched, kitnet_score once per eval chunk plus
               once for fit's training-set score, and kitnet_ae at least once
               (fit's ensemble pass).  Three more untraced passes over the
               eval stream give the run's own spread of eval pps.  Then the
               MD stage of one chunk (its 8 records scored and compared with
               the threshold) under torch.profiler: it must run 2 device
               kernels; the same stage as plain torch ops around the
               ensemble kernel is counted and timed beside it.
  trace   — the eval stream again under torch.profiler: the device's busy
               share (the events that ran on the card, each counted once),
               the device launches per chunk, and each kernel's device time
               per launch on the main path.
  sketch_main — the service with sketch state (n_slots=4096, rows=2) over
               the same traffic as phase 4, counts zeroed just before and
               read just after: sketch_update must have launched, and the
               KitNET kernels as in phase 4; more passes and its MD stage
               as in phase 4; then sketch_trace, its eval stream traced.
  5. ensemble — both KitNET kernels against their plain versions on the net
               fitted in phase 4: the ensemble (kitnet_ae) at its k, m and
               h on fit's batch (the main path's training records, 256)
               and on B=8192 gathered records, the scoring kernel
               (kitnet_score) on the main path's per-chunk batch and on
               B=8192 records (each <=1e-5, chunked == one shot bit for
               bit); kernel, plain and bound times at both batches of each.
               Then kitnet_ae's two designs (tile and pair), each forced,
               on the same inputs: equal bit for bit, and each one's time
               on the service's net at 8 to 8192 records and on nets of 7
               AEs at m = h = 33 and 64 (``designs``), the measurements
               behind the launcher's choice between them.
A kernel's ``ms`` is its device time per launch from torch.profiler, on the
inputs its bound is computed for; ``call_ms`` is the CUDA-event time per
back-to-back call, which includes the wrapper's host overhead.
  6. reference — the service on a small trace, on the card and on the CPU
               (plain versions) with the same net and threshold: equal record
               indices, scores within 1e-3, alarms equal off the threshold.
  sketch_reference — the same for the sketch service (rows=2, width 256,
               evict_age=1), with phase sketch_main's net.
  switch  — process_serial(mode="switch") on the card against the same call
               on the CPU (2048 packets of a mirai trace, n_slots=8192):
               features and every table bit for bit; the card's ms a packet;
               each switch arithmetic function on the card against the CPU
               over a grid of 4.4 M operands (mismatch counts, all 0).
  scan    — compute_features(backend="scan") on phase fc's chunk against
               backend="cuda" (fc_full) in the JAX package's scan envelope,
               the record-sampled path against the full path's rows and state
               bit for bit; device ms and sorts a call (profiler).
  scan_main — the service on backend="scan" over phase main's traffic,
               launch counts zeroed just before and read just after (no
               fc_full, the KitNET kernels as in phase main); eval pps, the
               device's busy share and AUC beside phase main's.
  partition — the partitioned FC backends: the service on
               backend="bucketed" at buckets=4 and 16 over phase main's
               traffic, launch counts zeroed just before and read just after
               (no fc_full, the KitNET kernels as on the main path; record
               indices the epoch closers, finite scores), eval pps, device
               launches a chunk (profiler, first 8 eval chunks) and AUC
               beside phase main's; bucketed on
               phase fc's chunk against fc_full in the scan envelope, device
               ms and sorts a call; backend="sharded" on phase switch's 2048
               packets, exact mode at shards=4 and 16 against the card's
               serial oracle and switch mode at shards=4 against the CPU's,
               features and every table bit for bit, card ms a packet.
  engine  — the multi-tenant engine with phase main's net: the
               tenant-batched fc_full on tenants {0, 2, 3} of a 4-tenant pool
               at n_slots=8192 (8192-packet eval chunks at three offsets)
               against its plain version (process_serial lane by lane) and
               three single launches, bit for bit, features and every pool
               table; its device ms against the three launches', and the
               profiler's count of each FC kernel a batched call (once).
               Then 4 tenants each fed the 262,144 eval packets through
               DetectionEngine.run (chunk 8192, epoch 1024, queue depth 4),
               counts zeroed just before and read just after (one fc_full and
               one kitnet_score launch a batch of 4 lanes), each tenant
               against its solo process_stream bit for bit (results and end
               state); aggregate pps, worst-tenant p99, slot collisions
               (the engine's device count against the host count of each
               chunk, equal, and the two timed), busy share and device launches a batched call (profiler), the
               single stream's eval pps and the ratio of the two over 3
               alternating rounds; 4 tenants on syn_dos, ssdp_flood,
               goldeneye and fuzzing (16,384 packets each) and 2 tenants on
               the sketch layout (4096 wide, rows 2, phase sketch_main's net),
               each against its solo service bit for bit.
  mesh    — the Peregrine path placed over a mesh: flow_mesh(devices=
               ["cuda:0"] * 4), and one place a card where the host has two
               or more (with one card the record says the cross-card path
               was not run).  On the main traffic: the bucketed service at
               S=4 and 16 from phase partition's post-fit tables, each pass
               the bits of partition's unplaced eval (indices and scores);
               sharded at S=4 on phase switch's 2,048 packets, bit for bit
               with phase partition's card serial; the sketch service under
               the mesh, unchanged; 4 tenants through DetectionEngine.run
               built under the mesh (tenant t's tables on place t % 4, never
               moved), bit for bit with the unplaced engine, one fc_full
               and one kitnet_score launch a place a batch.  Each case: eval
               or aggregate pps placed and unplaced (the services u, p; the
               engine u, p, p, u), device launches a chunk (profiler, over
               2 chunks, 2 batches or 4 packets) and bytes handed between
               places a chunk.
  eval    — the evaluation protocol, launch counts zeroed just before each
               part and read just after: sweep_attack in exact mode over
               phase main's traffic at rates 64, 256 and 1024 (fc_full and
               both KitNET kernels must launch); run_peregrine (exact) and
               run_kitsune_baseline at rate 256; sweep_attack (rates 1 and
               256) at its defaults, switch mode, on a mirai trace of 4096 +
               4096 packets, and run_peregrine (rate 64) at its defaults on
               1024 + 1024 packets; AUC, F1 and
               seconds of each; the plain MD path against kitnet_score on
               rate 256's records (1e-5).
  lm_main — LM serving of gemma2-2b at full width (26 layers, d_model
               2304, vocab 256,000, float32 parameters from seed 0, bf16
               cache) through launch.serve.serve_lm: the JAX launcher's
               traffic (4 slots, 8 requests of 16-token prompts, max_new 16,
               max_seq 256), then 4 requests of 8192-token prompts (max_new
               16, max_seq 8208); launch counts zeroed just before and read
               just after each; flash launches must be 26 per prefill.
  lm_trace — the long-prompt traffic again under torch.profiler: device
               busy share, and the top device and host ops of the prefills
               and of the decode steps.
  lm_reference — one 8192-token prefill and 16 teacher-forced decode steps
               with the same weights through the kernel and through the
               plain route (blockwise attention): logits within 1e-3,
               greedy tokens equal wherever the top-2 margin exceeds it.
  lm_families — the families beyond dense, each at full width with float32
               parameters from seed 0 and a bf16 cache, built, run and freed
               in turn: phi3.5-moe (4 of 32 layers), zamba2-2.7b, xlstm-125m,
               qwen2-vl-72b (4 of 80 layers) and hubert-xlarge.  A decoder
               serves lm_main's launcher traffic through ServeEngine (counts
               zeroed just before and read just after: flash launches equal
               attention applications x prefills: n_layers, 9 for zamba2, 0
               for the xLSTM), then one 2048-token prefill through the kernel
               and through the plain route and 16 decode steps fed the same
               tokens (lm_reference's check); the xLSTM's prefill of 2048
               tokens and 16 decode steps against one full forward;
               hubert one forward over 1500 frames of embeddings, kernel
               route against plain route (1e-3).  The xLSTM's prefill rows
               and decode steps against the full forward to XLSTM_REF_TOL
               (at this width a one-ulp nudge of its embeddings moves its
               logits by ~1e-2; measured beside them).  phi3.5-moe's dropped token
               slots in each prefill.  Then the flash kernel at zamba2's
               (H=K=32, D=80, S=2048, causal) and hubert's (H=K=16, D=80,
               S=1500, no causal mask) shapes against its plain version
               (2e-5), its time beside the plain version's and
               scaled_dot_product_attention's.
  train_main — LM training of gemma2-2b at full width and depth (float32
               parameters from seed 0, bf16 compute, AdamW) through
               training.make_train_step: the JAX launcher's batch 8 x seq 128
               from lm_batches(seed=0), warmup 1, 10 steps.  After step 1
               every parameter has a finite, nonzero gradient; losses finite
               and the last 3's mean below the first.  Seconds a step
               (median of steps 3-10), tokens/s, peak memory, the device's
               busy share over steps 3-10 and the model-FLOPs share (6 N
               tokens a step over the step time, of 989 TFLOP/s) from
               torch.profiler, and step 10's top device ops.  No kernel of
               the port launches on this path.
  train_reference — reduced gemma2-2b, 3 steps on the card against 3 on the
               CPU from the same state and batches in float32 compute: the
               plain step, remat "dots" and int8 error feedback, each within
               tests/test_torch_training.py's envelope (loss and grad norm
               1e-5 relative; parameters within 2 * sum(lr), at most 1e-4
               of them past 1e-5 + 1e-5 |p|; int8: grad norm 1e-4, at most
               1e-3 past).
  train_resume — launch.train.train_lm at --reduced (10 steps, checkpoints
               every 2 under chiprun_out/train_ckpt, removed after), then
               resilient_loop with failures at steps 3, 7, 7 over 12 batches
               against an uninterrupted run (rtol 1e-5, atol 1e-6), then its
               last checkpoint restored into a CPU state, equal to the card's.
  train_families — each family beyond dense trained at full width (float32
               parameters from seed 0, bf16 compute, the launcher's lr 3e-4
               and warmup 1, batch 8 x 128 from lm_batches(seed=0); hubert
               seeded embeds with cluster labels), 6 steps, one model at a
               time, depth cut only where the state would not fit:
               zamba2-2.7b, xlstm-125m and hubert-xlarge whole, phi3.5-moe
               2 of 32 layers (AdamW), qwen2-vl-72b 2 of 80 (Adafactor);
               kimi-k2 has no full-width cut that fits one card.  After
               step 1 every leaf (each layer's slice of a stacked leaf) has
               a finite, nonzero gradient, but hubert's embed (zero by
               design, as in JAX); every loss finite and the last below the
               first; the five kernels' counts stay 0.  Seconds a step
               (median of steps 3-6), tokens/s, peak memory, the
               model-FLOPs share (6 x active parameters x tokens, the MoE's
               top-k experts only, of 989 TFLOP/s) and the MoE's dropped
               slots a step.
  train_families_reference — the six non-dense archs reduced, 3 steps on
               the card against 3 on the CPU in float32 compute, within
               tests/test_torch_train_families.py's envelopes (loss, MoE
               aux and grad norm 1e-5 relative, the xLSTM's grad norm from
               step 2 on 5e-5; parameters within 2 * sum(lr), at most 1e-4
               past 1e-5 + 1e-5 |p|); no kernel launches.
  lm_mesh — the LM stack placed over a mesh (places repeated on cuda:0,
               and a card a place where the host has four): the placed train
               step (gemma2-2b at full width cut to LM_MESH_LAYERS of 26
               layers, float32 compute, AdamW, ZeRO-1, 2x2, batch 8 x 128, 5
               steps) against the one-device step at microbatches=2 within
               train_resume's envelope; s a step both ways (median of steps
               2-4), tokens/s, peak memory, bytes a place of the parameters
               and of m and v, bytes handed between places a step, device
               launches of the traced step 5.  moe_ffn_local at phi3.5-moe's
               width (d 4096, 16 experts, top-2, d_ff_expert 6400, 4 x 512
               tokens) on 2x4 places against the dense dispatch at capacity
               factor 8 (forward 1e-4, gradients 1e-3), each dispatch's
               dropped slots at the config's factor 1.25 and at 1.0.
               Sequence-parallel decode (B=4, H=8, K=4, D=256, an 8192-token
               cache) over 4 places against decode_attention (1e-4).
               Reduced gemma2-2b's placed state saved on 2x2 and restored
               on 4x1 and 1x1 bit for bit; the launcher's --mesh 2x2 at 1
               layer.  The five kernels' counts stay 0.  The step's
               gradients are reduced to each place's optimizer block, its
               leaf-wide work runs on those blocks: each step's placed
               update held bit for bit against the one-device update of
               the same gradients at the placed clip scale, the clip norm
               within 1e-6; the same for a run with the weights cut over
               the data places too (FSDP, assembled a layer at a time); the
               meta dry run's peak of each step against the card's growth.
  dryrun     — five production cells of the dry run on the meta device
               (launch/dryrun.py), one replica run a cell: gemma2-2b
               train_4k, qwen2-vl-72b prefill_32k and train_4k, zamba2-2.7b
               long_500k, kimi-k2 decode_32k (2x16x16), within 120 s;
               kimi-k2's largest place within a card, qwen2-vl-72b
               train_4k's place 0 within 10% of its largest other place.
Then the kernel table line, the card line, and the result line last.  The
phases' records also go to chiprun_out/chip_smoke.json.

Without a CUDA device, or without the repository's src/ beside it, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FC_TOL = dict(rtol=1e-4, atol=1e-3)     # the sketch cases' report, before bitwise
MD_TOL = 1e-5
SCORE_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM, bf16 tensor cores, dense
# the float32 flash kernel's products as split TF32: three TF32 tensor-core
# products (495 TFLOP/s dense) for each float32 one
TF32X3_FLOPS = 495e12 / 3
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}   # tests/test_kernels.py
FLASH_MODEL_TOL = 2e-5          # tests/test_kernels.py:115-116, model path
# bf16 at the model shape: both sides compute in f32 and differ only in the
# output's rounding, so at most one bf16 ulp, which is <= 2**-7 * |want|
FLASH_MODEL_BF16_RTOL, FLASH_MODEL_BF16_ATOL = 2.0 ** -7, 1e-5
LM_REF_TOL = 1e-3               # logits, kernel route against plain route
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's matrix-product kernels
# the device kernels of a wrapper that launches more than one, each once a
# call (a launch is counted by the first)
DEVICE_KERNELS = {"sketch_update": ("sketch_update_kernel", "sketch_schedule_kernel",
                                    "sketch_features_kernel"),
                  "fc_full": ("fc_chain_kernel", "fc_scan_kernel", "fc_prelude_kernel",
                              "fc_residual_kernel", "fc_sr_kernel", "fc_features_kernel"),
                  "feature_update": ("feature_update_chain_kernel",
                                     "feature_update_prelude_kernel",
                                     "feature_update_stats_kernel")}


T_START = time.perf_counter()


def emit(record: dict, log: list) -> None:
    record["at_s"] = time.perf_counter() - T_START      # seconds since start
    log.append(record)
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, from CUDA events around
    ``reps`` back-to-back calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof, averages=None) -> dict:
    """Self device time (µs) and count per name, of the events that ran on
    the card (kernels, copies, memsets) only.  The host-side ops that
    launched them also carry their device time, so summing every entry of
    ``key_averages()`` would count most of it twice.  ``averages``: the
    profile's ``key_averages()`` where the caller has them already."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages() if averages is None else averages:
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                out[e.key] = (us, e.count)
    return out


def kernels_ms(fn, reps: int, names):
    """Mean device time (ms) per launch of each kernel whose name contains
    one of ``names``, over ``reps`` calls of ``fn``, from torch.profiler; None
    if the profiler saw no device time for one of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    out = {}
    for name in names:
        hits = [(us, count) for key, (us, count) in events.items() if name in key]
        calls = sum(c for _, c in hits)
        if not calls:
            return None
        out[name] = sum(us for us, _ in hits) / calls * 1e-3
    return out


def timed(fn, reps: int, kernel) -> dict:
    """``ms``: the device time per call of the kernel ``kernel`` (or of the
    kernels in a tuple of names, each launched once a call, summed; each
    apart under ``parts_ms``) from the profiler, or the CUDA event time per
    call where the profiler saw none; ``call_ms``: the CUDA event time per
    back-to-back call, host overhead included."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    call = cuda_ms(fn, reps)
    dev = kernels_ms(fn, reps, names)
    out = {"ms": call if dev is None else sum(dev.values()), "call_ms": call,
           "ms_from": "events" if dev is None else "profiler"}
    if len(names) > 1:
        out["parts_ms"] = dev
    return out


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def assert_close(got: torch.Tensor, want: torch.Tensor, what: str, **tol) -> None:
    torch.testing.assert_close(got, want, msg=lambda m: f"{what}: {m}", **tol)


def trace_eval(svc, pkts, eval_s: float, kernels) -> dict:
    """The eval stream once more under torch.profiler: the device's busy
    share and each kernel's device time by name (profiler overhead inflates
    the traced wall time, so the busy share is also given against the
    untraced ``eval_s``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.process_stream(pkts, chunk=8192)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = device_events(prof)
    dev_us = {key: us for key, (us, _) in events.items()}
    kern_us, kern_calls = {}, {}
    for key, (us, count) in events.items():
        for kern in kernels:
            names = DEVICE_KERNELS.get(kern.name, (f"{kern.name}_kernel",))
            for pos, name in enumerate(names):
                if name in key:
                    kern_us[kern.name] = kern_us.get(kern.name, 0.0) + us
                    if pos == 0:
                        kern_calls[kern.name] = kern_calls.get(kern.name, 0) + count
    busy_s = sum(dev_us.values()) * 1e-6
    # each kernel's device time per launch on the path, at its shapes
    traced_ms = {name: kern_us[name] / kern_calls[name] * 1e-3 for name in kern_us}
    chunks = -(-len(pkts["ts"]) // 8192)
    launched = sum(count for _, count in events.values())
    return {"traced_s": traced_s, "device_busy_s": busy_s,
            "chunks": chunks, "device_launches": launched,
            "device_launches_per_chunk": launched / chunks,
            "busy_share_traced": busy_s / traced_s,
            "busy_share_untraced": busy_s / eval_s,
            "kernel_device_ms_per_launch": traced_ms,
            "kernel_share_of_busy": {name: kern_us[name] * 1e-6 / busy_s
                                     for name in kern_us},
            "kernel_launches_traced": kern_calls,
            "top_device_us": dict(sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]),
            "top_host_self_us": dict(sorted(
                ((e.key, e.self_cpu_time_total) for e in prof.key_averages()),
                key=lambda kv: -kv[1])[:12])}


def md_stage_launches(net, threshold: float, md_backend: str, dev) -> dict:
    """One chunk's MD stage (its records scored, then compared with the
    threshold, as serving/fused.py's step does) through the backend's
    scoring function ("fused"), and through the plain stages around the
    ensemble kernel ("unfused", the route before the scoring kernel): the
    device kernels each runs a call, from torch.profiler over 200 calls, as
    all device events per event of its KitNET kernel (a window of one call
    can come back empty), and its CUDA-event time a call, host overhead
    included.  The fused stage must run 2."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.detection.md_backends import _ensemble_cuda, _scorer, md_score_fn
    U = torch.rand(8, net.norm_min.shape[0], generator=torch.Generator().manual_seed(5))
    X = net.norm_min + 1.5 * U.to(dev) * (net.norm_max - net.norm_min)
    out = {}
    for name, score, kern in (("fused", md_score_fn(md_backend), "kitnet_score_kernel"),
                              ("unfused", _scorer(_ensemble_cuda), "kitnet_ae_kernel")):
        def stage():
            return score(net, X) > threshold
        call_ms = cuda_ms(stage, reps=200)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                stage()
            torch.cuda.synchronize()
        events = device_events(prof)
        total = sum(count for _, count in events.values())
        ours = sum(count for key, (_, count) in events.items() if kern in key)
        out[name] = {"device_launches": total / max(ours, 1), "events": total,
                     f"{kern}_events": ours, "call_ms": call_ms}
    if not (out["fused"]["kitnet_score_kernel_events"] >= 100
            and round(out["fused"]["device_launches"]) == 2):
        raise RuntimeError(f"the MD stage ran {out['fused']} device kernels, not 2")
    return out


def eval_passes(svc, pkts, n: int = 3) -> list:
    """Eval pps of n more untraced passes over the eval stream (the flow
    tables carry on): the run's own spread, as the host's speed varies from
    run to run and within one."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.process_stream(pkts, chunk=8192)
        torch.cuda.synchronize()
        out.append(len(pkts["ts"]) / (time.perf_counter() - t0))
    return out


def check_kitnet_launches(launches: dict, chunks: int, where: str) -> None:
    """Every eval chunk scored by one kitnet_score launch, plus fit's
    training-set score; fit's ensemble pass through kitnet_ae."""
    if launches["kitnet_score"] != chunks + 1 or launches["kitnet_ae"] < 1:
        raise RuntimeError(f"{where}: kitnet_score launched {launches['kitnet_score']} "
                           f"times for {chunks} eval chunks + fit, kitnet_ae "
                           f"{launches['kitnet_ae']} times")


def sass_counts(lib: Path, opcodes=("HGMMA", "HMMA", "FFMA")) -> dict:
    """Instructions of each opcode in each kernel of a built library, from
    ``cuobjdump -sass`` (the toolkit's, beside nvcc)."""
    from repro_torch.kernels.build import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(opcodes, 0)
        elif name is not None:
            for op in opcodes:
                if f" {op}." in line or f" {op} " in line:
                    counts[name][op] += 1
    return counts


def bound(byts: float, ops: float, peak: float = FP32_FLOPS) -> dict:
    """The least time the card could take: bytes over the HBM rate or float
    operations over ``peak`` (the float32 rate unless given), whichever is
    larger."""
    by_bytes = byts / HBM_BYTES_PER_S >= ops / peak
    return {"bound_ms": max(byts / HBM_BYTES_PER_S, ops / peak) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def sketch_cost(pk, rows: int, width: int) -> Tuple[float, float]:
    """Bytes and float operations one sketch call needs on this chunk: the
    function's inputs read once (the R hashed rows of each of the 4 key
    types, hashed outside the kernel as in the TPU kernel, dir, ts, length,
    evict_age), every touched cell read once and written once, 320 B of
    features a packet; about 20 operations a (row, decay) cell and 30 a
    decay for the statistics."""
    from repro_torch.kernels.sketch_update import kernel_rows
    idx, dirb = kernel_rows(pk, rows, width)
    n = idx.shape[1]
    uni = torch.unique(idx[:2]).numel()                 # uni rows, 4 tables
    d = dirb[None, :, None].expand_as(idx[2:])
    own = torch.unique(idx[2:] * 2 + d)
    opp = torch.unique(idx[2:] * 2 + 1 - d)
    either = torch.unique(torch.cat([own, opp])).numel()
    sr = torch.unique(idx[2:]).numel()                  # SR rows, 3 tables
    byts = (n * (4 * rows * 4 + 4 + 4 + 4) + 4 + n * 80 * 4
            + uni * 4 * 16 * 2
            + (either - opp.numel()) * 4 * 16 + opp.numel() * 5 * 16
            + own.numel() * 5 * 16 + sr * 3 * 16 * 2)
    ops = n * 4 * 4 * (rows * 20 + 30)
    return byts, ops


def sketch_build_record(kern) -> dict:
    """Per instantiation of the sketch kernels: ptxas's registers, stack,
    spills and static shared memory, and the schedule's dynamic shared
    memory with its level counts inside (n <= 8192) and outside it."""
    import ctypes
    import re
    smem_of = ctypes.CDLL(str(kern.lib_path())).sketch_schedule_smem
    smem_of.argtypes, smem_of.restype = [ctypes.c_int], ctypes.c_int

    def key(mangled):
        m = re.search(r"sketch_update_kernelILi(\d+)ELb([01])E", mangled)
        if m:
            return f"update_RP{m.group(1)}" + ("_multirow" if m.group(2) == "1" else "")
        for name in ("sketch_schedule_kernel", "l2_chase_kernel"):
            if name in mangled:
                return name.replace("_kernel", "").replace("sketch_", "")
        return None

    out, cur = {}, None
    for line in kern.build_log.splitlines():
        if "Compiling entry function" in line:
            cur = key(line)
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    if "schedule" in out:
        out["schedule"]["dynamic_smem_bytes"] = {"n<=8192": smem_of(8192),
                                                 "n>8192": smem_of(8193)}
    return out


def l2_round_trip_ms(kern, dev) -> float:
    """One dependent load through L2, in ms: one thread follows a random
    cycle over 1 MiB of int32 indices with loads that skip L1
    (``sketch_l2_chase_launch``), timed with CUDA events after a pass that
    brings every index into L2."""
    import ctypes
    fn = ctypes.CDLL(str(kern.lib_path())).sketch_l2_chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size, steps = 1 << 18, 1 << 16
    perm = torch.randperm(size, generator=torch.Generator().manual_seed(0))
    nxt = torch.empty(size, dtype=torch.int32)
    nxt[perm] = perm.roll(-1).to(torch.int32)
    nxt = nxt.to(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(k):
        code = fn(nxt.data_ptr(), k, out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"l2 chase: launch failed with CUDA error {code}")

    run(size)
    return cuda_ms(lambda: run(steps), 3) / steps


SKETCH_NAMES = ("sketch_schedule_kernel", "sketch_update_kernel",
                "sketch_features_kernel")


def states_equal(a, b) -> bool:
    return all(torch.equal(a[g][k], b[g][k]) for g in ("uni", "bi") for k in b[g])


def sketch_case(st0, p, rows: int, width: int, name: str):
    """The sketch kernels on ``p`` from ``st0`` against process_sketch on the
    card, features and every table bit for bit, and the card's schedule
    against its twin; returns the kernel's state and features and the
    case's record."""
    from repro_torch.core.sketch import process_sketch
    from repro_torch.core.state import clone_state
    from repro_torch.kernels.sketch_update import (kernel_rows, round_size,
                                                   sketch_schedule_ref,
                                                   sketch_update_full)
    sched = {}
    st_k, f_k = sketch_update_full(clone_state(st0), p, schedule=sched)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, f_p = process_sketch(clone_state(st0), p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert_close(f_k, f_p, f"sketch {name} features", **FC_TOL)
    err = max_abs(f_k, f_p)
    for g in ("uni", "bi"):
        for key in st_p[g]:
            assert_close(st_k[g][key], st_p[g][key], f"sketch {name} state "
                         f"{g}/{key}", **FC_TOL)
            err = max(err, max_abs(st_k[g][key], st_p[g][key]))
    if not (torch.equal(f_k, f_p) and states_equal(st_k, st_p)):
        raise RuntimeError(f"sketch {name}: kernel and process_sketch differ "
                           f"(max abs err {err})")
    want = sketch_schedule_ref(kernel_rows(p, rows, width)[0], width)
    same = (sched["depth"] == want["depth"] and sched["rounds"] == want["rounds"]
            and all(torch.equal(sched[key].cpu(), want[key])
                    for key in ("level", "order"))
            and all(torch.equal(a.cpu(), b) for a, b in
                    zip(sched["round_starts"], want["round_starts"])))
    if not same:
        raise RuntimeError(f"sketch {name}: the card's schedule differs from "
                           "its twin")
    return st_k, f_k, {"packets": int(p["ts"].shape[0]), "max_abs_err": err,
                       "bitwise": True, "schedule_equals_twin": True,
                       "plain_ms": plain_ms, "depth": want["depth"],
                       "rounds": want["rounds"], "round_size": round_size(rows)}


def phase_sketch(dev, pk8192, st_dense, log) -> dict:
    """The sketch kernels against their plain versions, run on the card, bit
    for bit (features and every table) and the schedule against its twin:
    at the sketch main path's W=4096, R=2 on the second 8192-packet chunk
    of a mirai stream, from the state the first chunk left (as every chunk
    but the first meets it on the main path); on one 4096-packet chunk at
    W=64, R=4 with eviction (rows collide, cells age out) from a fresh
    state; and on an 8192-packet chunk of one flow (a level a packet).
    Chunked carry against one shot; at R=1, W=8192 its state against the
    dense FC kernel's.  Times of the schedule, update and features apart,
    and the chain floor: the deepest level times one dependent L2 round
    trip."""
    from repro_torch.core.state import clone_state, init_state
    from repro_torch.kernels.sketch_update import SKETCH_UPDATE, sketch_update_full
    from repro_torch.traffic import synth_trace, to_torch

    stream = to_torch(synth_trace("mirai", n_train=64, n_benign_eval=8192,
                                  n_attack=8192, seed=0)["eval"], dev)
    chunk2 = {k: v[8192:16384] for k, v in stream.items()}
    st_main = init_state(4096, "sketch", device=dev, rows=2)
    sketch_update_full(st_main, {k: v[:8192] for k, v in stream.items()})
    tr = synth_trace("mirai", n_train=64, n_benign_eval=2048, n_attack=2048,
                     seed=0)["eval"]
    pk = to_torch(tr, dev)
    n = len(tr["ts"])
    one = {k: v[:1].repeat(8192) for k, v in chunk2.items()}
    one["ts"] = torch.arange(8192, device=dev, dtype=torch.float32) * 1e-3
    cases, out = {}, {}
    for name, st0, p, rows, width in (
            ("W4096_R2_age0.0", st_main, chunk2, 2, 4096),
            ("W64_R4_age0.5", init_state(64, "sketch", device=dev, rows=4,
                                         evict_age=0.5), pk, 4, 64),
            ("single_flow_W4096_R2", init_state(4096, "sketch", device=dev,
                                                rows=2), one, 2, 4096)):
        st_k, f_k, cases[name] = sketch_case(st0, p, rows, width, name)
        out[name] = (st_k, f_k)
    st_age, f_age = out["W64_R4_age0.5"]
    # eviction had an effect: the same chunk without aging differs
    _, f_noage = sketch_update_full(
        init_state(64, "sketch", device=dev, rows=4), pk)
    changed = float((f_noage != f_age).float().mean())
    if changed == 0.0:
        raise RuntimeError("sketch: no cell aged out in the eviction case")
    cases["W64_R4_age0.5"]["features_changed_by_eviction"] = changed
    # chunked carry against one shot (so against process_sketch), bit for bit
    st_c = init_state(64, "sketch", device=dev, rows=4, evict_age=0.5)
    f_c = torch.cat([sketch_update_full(st_c, {k: v[i:i + 1000] for k, v in pk.items()})[1]
                     for i in range(0, n, 1000)])
    if not (torch.equal(f_c, f_age) and states_equal(st_c, st_age)):
        raise RuntimeError("sketch: chunked carry differs from one shot")
    # R=1, W=8192: the sketch kernel's state is the dense FC kernel's
    st_1, _ = sketch_update_full(init_state(8192, "sketch", device=dev, rows=1), pk8192)
    for g in ("uni", "bi"):
        for key in st_dense[g]:
            if key != "rr" and not torch.equal(st_1[g][key][:, 0], st_dense[g][key]):
                raise RuntimeError(f"sketch R=1 state {g}/{key} differs from fc_full's")
    # times: the compared main-path case, each call on a fresh copy of the
    # state the first chunk left (call_ms includes the 4.25 MiB copy); the
    # same chunk replayed onto the state it left itself, where every cell's
    # last time is at or past the packet's, so dt = 0; the single flow
    t_main = timed(lambda: sketch_update_full(clone_state(st_main), chunk2), 20,
                   SKETCH_NAMES)
    st_r = clone_state(st_main)
    sketch_update_full(st_r, chunk2)
    t_replay = timed(lambda: sketch_update_full(st_r, chunk2), 20, SKETCH_NAMES)
    st_one = init_state(4096, "sketch", device=dev, rows=2)
    t_single = timed(lambda: sketch_update_full(st_one, one), 5, SKETCH_NAMES)
    l2_ms = l2_round_trip_ms(SKETCH_UPDATE, dev)
    main_case = cases["W4096_R2_age0.0"]
    for t, case in ((t_main, main_case), (t_single, cases["single_flow_W4096_R2"])):
        case["chain_floor_ms"] = max(case["depth"]) * l2_ms
        parts = t.get("parts_ms") or {}
        t["schedule_ms"] = parts.get("sketch_schedule_kernel")
        t["update_ms"] = parts.get("sketch_update_kernel")
        t["features_ms"] = parts.get("sketch_features_kernel")
        t["us_per_round"] = (t["update_ms"] * 1e3 / max(case["rounds"])
                             if t["update_ms"] is not None else None)
    return {"name": "sketch_update", "route": "cuda",
            "source": "src/repro_torch/csrc/sketch_update.cu",
            "replaces": "src/repro/kernels/sketch_update.py:243",
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            **t_main, "plain_ms": main_case["plain_ms"],
            **bound(*sketch_cost(chunk2, 2, 4096)), "library_ms": None,
            "chain_floor_ms": main_case["chain_floor_ms"],
            "l2_round_trip_ns": l2_ms * 1e6,
            "shape": {"packets": 8192, "width": 4096, "rows": 2, "chunk": 2},
            "cases": cases, "chunked_bitwise": True,
            "r1_state_equals_fc_full": True, "replayed_chunk": t_replay,
            "single_flow_chunk": t_single,
            "build": sketch_build_record(SKETCH_UPDATE)}


FC_NAMES = DEVICE_KERNELS["fc_full"]
FU_NAMES = DEVICE_KERNELS["feature_update"]


def chain_step_ms(dev) -> float:
    """One step of the FC chains' form, w = w*d + 1 (two dependent float32
    operations, unfused), in ms: one thread runs 2^20 of them
    (``fc_chain_probe_launch``), timed with CUDA events."""
    import ctypes
    from repro_torch.kernels.feature_update import FC_FULL
    fn = ctypes.CDLL(str(FC_FULL.lib_path())).fc_chain_probe_launch
    fn.argtypes = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = 1 << 20

    def run():
        code = fn(0.999, steps, out.data_ptr(), stream)
        if code:
            raise RuntimeError(f"chain probe: launch failed with CUDA error {code}")

    return cuda_ms(run, 3) / steps


def fc_case(st0, pk, what: str):
    """The FC kernels on ``pk`` from ``st0`` against process_serial on the
    card, features and every table bit for bit; returns the kernel's state
    and features, the plain version's ms and the largest difference."""
    from repro_torch.core.pipeline import process_serial
    from repro_torch.core.state import clone_state
    from repro_torch.kernels.feature_update import feature_update_full
    st_k, f_k = feature_update_full(clone_state(st0), pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, f_p = process_serial(clone_state(st0), pk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max([max_abs(f_k, f_p)] + [max_abs(st_k[g][k], st_p[g][k])
                                     for g in ("uni", "bi") for k in st_p[g]])
    if not (torch.equal(f_k, f_p) and states_equal(st_k, st_p)):
        raise RuntimeError(f"fc {what}: kernel and process_serial differ "
                           f"(max abs err {err})")
    return st_k, f_k, plain_ms, err


def phase_fc(dev, step_ms: float):
    """The FC kernels against the serial oracle on the card, bit for bit, on
    one 8192-packet mirai chunk at n_slots=8192, chunked and in one shot,
    and on an 8192-packet chunk of one flow; times, segments and the chain
    floor.  Returns the record, the chunk and the kernel's state."""
    from repro_torch.core.pipeline import packet_rows
    from repro_torch.core.state import clone_state, init_state
    from repro_torch.kernels.feature_update import (fc_segments,
                                                    feature_update_full)
    from repro_torch.traffic import synth_trace, to_torch
    n_slots, chunk = 8192, 8192
    tr = synth_trace("mirai", n_train=64, n_benign_eval=chunk // 2,
                     n_attack=chunk // 2, seed=1)["eval"]
    pk = to_torch(tr, dev)
    st0 = init_state(n_slots, device=dev)
    st_k, f_k, plain_ms, err = fc_case(st0, pk, "mirai chunk")
    st_c = clone_state(st0)
    parts = []
    for i in range(0, chunk, 1000):
        st_c, f = feature_update_full(st_c, {k: v[i:i + 1000] for k, v in pk.items()})
        parts.append(f)
    if not (torch.equal(torch.cat(parts), f_k) and states_equal(st_c, st_k)):
        raise RuntimeError("fc: chunked carry differs from one shot")

    st_w = clone_state(st_k)
    fc_time = timed(lambda: feature_update_full(st_w, pk), 50, FC_NAMES)
    # bound: the function's inputs (4 key rows int32, dir, ts, length) read
    # once, touched rows read and written once, features written once;
    # segments counted from this chunk's keys
    skey, _ = fc_segments(packet_rows(pk, n_slots), n_slots)
    segs = torch.ones_like(skey, dtype=torch.bool)
    segs[1:] = skey[1:] != skey[:-1]
    seg_kt = skey[segs] // n_slots
    n_uni = int((seg_kt < 2).sum())
    n_bi = int((seg_kt >= 2).sum())
    seg_len = torch.diff(torch.cat([torch.nonzero(segs).flatten(),
                                    torch.tensor([skey.numel()], device=dev)]))
    longest = int(seg_len.max())
    fc_bytes = (chunk * (4 * 4 + 4 + 4 + 4)                 # rows, dir, ts, len
                + n_uni * 4 * 16 * 2 + n_bi * (10 + 2) * 16 * 2
                + chunk * 80 * 4)
    fc_flops = chunk * (2 * 4 * 16 + 2 * 4 * 45)
    # one flow: every key type one segment of the whole chunk
    one = {k: v[:1].repeat(chunk) for k, v in pk.items()}
    one["ts"] = torch.arange(chunk, device=dev, dtype=torch.float32) * 1e-3
    st_one0 = init_state(n_slots, device=dev)
    _, _, one_plain_ms, one_err = fc_case(st_one0, one, "one flow")
    st_one = clone_state(st_one0)
    t_one = timed(lambda: feature_update_full(st_one, one), 5, FC_NAMES)
    return ({"name": "fc_full", "route": "cuda",
             "source": "src/repro_torch/csrc/fc_full.cu",
             "replaces": "src/repro/kernels/feature_update.py:339",
             "max_abs_err": max(err, one_err), **fc_time, "plain_ms": plain_ms,
             **bound(fc_bytes, fc_flops), "library_ms": None,
             "chain_floor_ms": longest * step_ms, "chain_step_ns": step_ms * 1e6,
             "shape": {"packets": chunk, "n_slots": n_slots},
             "segments": {"uni": n_uni, "bi": n_bi, "longest": longest},
             "bitwise": True, "chunked_bitwise": True,
             "one_flow_chunk": {**t_one, "packets": chunk, "bitwise": True,
                                "plain_ms": one_plain_ms,
                                "chain_floor_ms": chunk * step_ms}},
            pk, st_k)


def phase_fc_single(dev, pk8192, step_ms: float) -> Tuple[dict, int]:
    """The single-key kernels: their public entry point driven once with the
    launch counts zeroed just before (its path), then held against their
    plain version on the card at n=8192, n_slots=8192 bit for bit; chunked
    == one shot bit for bit; times and the chain floor."""
    from repro_torch.core.state import packet_slots
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.feature_update import (TABLE_KEYS, feature_update,
                                                    feature_update_ref)
    n_slots = 8192
    slots = packet_slots(pk8192, n_slots)["src_ip"]
    ts, lens = pk8192["ts"], pk8192["length"]
    n = ts.shape[0]

    def fresh():
        return {f: torch.full((n_slots, 4), -1.0 if f == "last_t" else 0.0,
                              device=dev) for f in TABLE_KEYS}

    reset_launch_counts()
    tab_k, s_k = feature_update(fresh(), slots, ts, lens)
    torch.cuda.synchronize()
    launches = launch_counts()["feature_update"]
    if launches == 0:
        raise RuntimeError("feature_update did not launch its kernel")
    t0 = time.perf_counter()
    tab_p, s_p = feature_update_ref(fresh(), slots, ts, lens)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max([max_abs(s_k, s_p)] + [max_abs(tab_k[k], tab_p[k]) for k in TABLE_KEYS])
    if not (torch.equal(s_k, s_p) and all(torch.equal(tab_k[k], tab_p[k])
                                          for k in TABLE_KEYS)):
        raise RuntimeError(f"fc_single: kernel and feature_update_ref differ "
                           f"(max abs err {err})")
    tab_c = fresh()
    s_c = torch.cat([feature_update(tab_c, slots[i:i + 1000], ts[i:i + 1000],
                                    lens[i:i + 1000])[1] for i in range(0, n, 1000)])
    if not (torch.equal(s_c, s_k) and all(torch.equal(tab_c[k], tab_k[k])
                                          for k in TABLE_KEYS)):
        raise RuntimeError("fc_single: chunked carry differs from one shot")
    tab_w = {k: v.clone() for k, v in tab_k.items()}
    t = timed(lambda: feature_update(tab_w, slots, ts, lens), 50, FU_NAMES)
    # the same packets on uniformly drawn slots (runs of a few packets)
    uniform = torch.from_numpy(np.random.default_rng(4).integers(
        0, n_slots, n)).to(dev)
    t_uniform = timed(lambda: feature_update(tab_w, uniform, ts, lens), 50, FU_NAMES)
    t_uniform["longest_run"] = int(torch.unique(uniform, return_counts=True)[1].max())
    # every packet in one slot: one run of n, bit for bit, then timed
    one = torch.zeros_like(slots)
    tab_o, s_o = feature_update(fresh(), one, ts, lens)
    tab_op, s_op = feature_update_ref(fresh(), one, ts, lens)
    if not (torch.equal(s_o, s_op) and all(torch.equal(tab_o[k], tab_op[k])
                                          for k in TABLE_KEYS)):
        raise RuntimeError("fc_single: one slot differs from feature_update_ref")
    t_one = timed(lambda: feature_update(tab_o, one, ts, lens), 5, FU_NAMES)
    t_one.update(longest_run=n, bitwise=True, chain_floor_ms=n * step_ms)
    _, counts = torch.unique(slots, return_counts=True)
    # the function's inputs (slot int32, ts, length) read once, touched rows
    # (4 tables) read and written once, 48 B of stats a packet; about 14
    # float operations a packet and decay
    byts = n * (4 + 4 + 4 + 48) + counts.numel() * 4 * 16 * 2
    return ({"name": "feature_update", "route": "cuda",
             "source": "src/repro_torch/csrc/feature_update.cu",
             "replaces": "src/repro/kernels/feature_update.py:105",
             "max_abs_err": err, **t, "plain_ms": plain_ms,
             **bound(byts, n * 4 * 14), "library_ms": None,
             "chain_floor_ms": int(counts.max()) * step_ms,
             "shape": {"packets": n, "n_slots": n_slots, "slots": "src_ip",
                       "touched_rows": int(counts.numel()),
                       "longest_run": int(counts.max())},
             "bitwise": True, "chunked_bitwise": True,
             "uniform_slots": t_uniform, "one_slot": t_one}, launches)


def phase_limits(dev, log) -> None:
    """The shapes the kernels take since this slice, each on the card against
    its plain version: sketch rows 9 and 16 (bit for bit), AE widths 33 and
    64, flash head dims 80 and 112 in both dtypes, and prefill positions
    arange(S) + c through the model's flash route."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.state import clone_state, init_state
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (built_head_dim,
                                                     flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.kitnet_ae import kitnet_ensemble, kitnet_ensemble_ref
    from repro_torch.kernels.sketch_update import sketch_update_full
    from repro_torch.models import build_model
    from repro_torch.traffic import synth_trace, to_torch
    rec = {}
    pk = to_torch(synth_trace("mirai", n_train=64, n_benign_eval=512,
                              n_attack=512, seed=6)["eval"], dev)
    for rows in (9, 16):
        st0 = init_state(64, "sketch", device=dev, rows=rows, evict_age=0.5)
        _, _, case = sketch_case(st0, pk, rows, 64, f"rows {rows}")
        case.update(timed(lambda: sketch_update_full(clone_state(st0), pk), 5,
                          SKETCH_NAMES))
        rec[f"sketch_W64_R{rows}"] = case
    rng = np.random.default_rng(8)
    for m in (33, 64):
        k, B = 7, 8192
        arrays = [rng.uniform(0.0, 1.2, (B, k, m)), rng.normal(0, 0.3, (k, m, m)),
                  rng.normal(0, 0.1, (k, m)), rng.normal(0, 0.3, (k, m, m)),
                  rng.normal(0, 0.1, (k, m)), (rng.random((k, m)) > 0.2) * 1.0]
        x, *args = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays)
        r_k = kitnet_ensemble(x, *args)
        err = max_abs(r_k, kitnet_ensemble_ref(x, *args))
        if not err <= MD_TOL:
            raise RuntimeError(f"ensemble m=h={m}: max abs err {err}")
        r_c = torch.cat([kitnet_ensemble(x[i:i + 37], *args) for i in range(0, B, 37)])
        if not torch.equal(r_c, r_k):
            raise RuntimeError(f"ensemble m=h={m}: chunked scores differ from one shot")
        rec[f"ae_m{m}_h{m}"] = {"B": B, "k": k, "max_abs_err": err, "tol": MD_TOL,
                                "chunked_bitwise": True,
                                **timed(lambda: kitnet_ensemble(x, *args), 20,
                                        "kitnet_ae_kernel")}
    for D in (80, 112):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            q, kk, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dt)
                        for s in ((1, 8, 1024, D), (1, 4, 1024, D), (1, 4, 1024, D)))
            kw = dict(causal=True, window=256, softcap=50.0)
            got = flash_attention(q, kk, v, **kw)
            want = flash_attention_ref(q, kk, v, **kw)
            err = max_abs(got.float(), want.float())
            if (got.shape != q.shape or got.dtype != dt
                    or not err <= FLASH_TOL[name]):
                raise RuntimeError(f"flash D={D} {name}: max abs err {err} "
                                   f"(tol {FLASH_TOL[name]})")
            rec[f"flash_{name}_D{D}"] = {
                "shape": [1, 8, 4, 1024, D], "padded_to": built_head_dim(D),
                "max_abs_err": err, "tol": FLASH_TOL[name],
                **timed(lambda: flash_attention(q, kk, v, **kw), 10,
                        "flash_attention_kernel")}
    cfg = reduced(get_arch("gemma2-2b"), head_dim=256)
    model = build_model(cfg, device=dev)
    params = model.init_params(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96))).to(dev)
    pos = torch.arange(96, device=dev)[None] + torch.tensor([[5], [40]], device=dev)
    reset_launch_counts()
    logits, _, _ = model.forward(params, {"tokens": toks, "positions": pos})
    n_flash = launch_counts()["flash_attention"]
    plain, _, _ = model.forward(params, {"tokens": toks, "positions": pos},
                                attn_impl="plain")
    err = max_abs(logits, plain)
    if n_flash != cfg.n_layers or not err <= FLASH_MODEL_TOL:
        raise RuntimeError(f"shifted positions: {n_flash} flash launches for "
                           f"{cfg.n_layers} layers, max abs err {err}")
    try:
        model.forward(params, {"tokens": toks, "positions": pos.flip(-1)})
    except ValueError:
        pass
    else:
        raise RuntimeError("reversed positions took the flash route")
    rec["positions_shifted"] = {"batch": 2, "S": 96, "shifts": [5, 40],
                                "layers": cfg.n_layers, "flash_launches": n_flash,
                                "max_abs_err": err, "tol": FLASH_MODEL_TOL,
                                "reversed_raises": True}
    emit({"phase": "limits", **rec}, log)


def phase_sketch_main(data, log) -> Tuple[dict, object]:
    """The detection service with Count-Min sketch state: n_slots=4096 wide,
    rows=2 (the top rung of benchmarks/approx_ablation.py's FULL_BUDGETS),
    over the main path's traffic; launch counts zeroed just before and read
    just after; then the eval stream traced."""
    from repro_torch.detection.metrics import auc
    from repro_torch.kernels import (KERNELS, SKETCH_UPDATE, launch_counts,
                                     reset_launch_counts)
    from repro_torch.serving import DetectionService

    svc = DetectionService(state_backend="sketch", n_slots=4096,
                           state_kw={"rows": 2})
    table_mib = sum(t.numel() * t.element_size()
                    for g in ("uni", "bi") for t in svc.state[g].values()) / 2 ** 20
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.observe_stream(data["train"], chunk=8192)
    svc.fit(seed=0, fpr=0.01)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eval_start = svc.pkt_count
    t0 = time.perf_counter()
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=8192)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches[SKETCH_UPDATE.name] == 0:
        raise RuntimeError("sketch_update never launched on the sketch path")
    n_eval = len(data["eval"]["ts"])
    check_kitnet_launches(launches, -(-n_eval // 8192), "sketch path")
    want_idx = np.arange(svc.epoch - 1 - eval_start % svc.epoch, n_eval,
                         svc.epoch) + eval_start
    if not np.array_equal(idx, want_idx):
        raise RuntimeError("sketch path record indices are not the epoch closers")
    if not (np.isfinite(scores).all() and scores.shape == idx.shape
            and alarms.shape == idx.shape):
        raise RuntimeError("sketch path scores are not finite or misshapen")
    labels = data["eval"]["label"][idx - eval_start]
    emit({"phase": "sketch_main", "n_slots": 4096, "rows": 2,
          "table_mib": table_mib, "epoch": svc.epoch,
          "train_pkts": len(data["train"]["ts"]), "eval_pkts": n_eval,
          "observe_fit_s": fit_s, "eval_s": eval_s, "eval_pps": n_eval / eval_s,
          "records": int(len(scores)), "alarms": int(alarms.sum()),
          "auc": auc(scores, labels), "threshold": svc.threshold,
          "launches": launches, "eval_pps_more_passes": eval_passes(svc, data["eval"]),
          "md_stage_device_launches": md_stage_launches(
              svc.net, svc.threshold, svc.md_backend, svc.device)}, log)
    emit({"phase": "sketch_trace", **trace_eval(svc, data["eval"], eval_s, KERNELS)},
         log)
    return launches, svc


def phase_sketch_reference(net_arrays, threshold: float, log) -> None:
    """The sketch service on a small trace, on the card (sketch kernel) and
    on the CPU (plain version), with the same net and threshold."""
    from repro_torch.interop import kitnet_from_arrays
    from repro_torch.serving import DetectionService
    from repro_torch.traffic import synth_trace

    small = synth_trace("syn_dos", n_train=64, n_benign_eval=1024,
                        n_attack=1024, seed=3)["eval"]
    outs = {}
    for where in ("cuda", "cpu"):
        s = DetectionService(epoch=64, n_slots=256, device=where,
                             threshold=threshold, state_backend="sketch",
                             state_kw={"rows": 2, "evict_age": 1.0})
        s.net = kitnet_from_arrays(net_arrays, device=where)
        outs[where] = s.process_stream(small, chunk=512)
    (i_g, s_g, a_g), (i_c, s_c, a_c) = outs["cuda"], outs["cpu"]
    if not np.array_equal(i_g, i_c):
        raise RuntimeError("sketch service: card and CPU record indices differ")
    score_err = float(np.abs(s_g - s_c).max())
    if not score_err <= SCORE_TOL:
        raise RuntimeError(f"sketch service: card vs CPU scores differ by {score_err}")
    near = np.abs(s_c - threshold) <= SCORE_TOL
    if not np.array_equal(a_g[~near], a_c[~near]):
        raise RuntimeError("sketch service: card and CPU alarms differ away "
                           "from the threshold")
    emit({"phase": "sketch_reference", "records": int(len(i_g)),
          "max_score_err": score_err, "alarms": int(a_g.sum())}, log)


# ---------------------------------------------------------------------------
# switch-mode arithmetic, the scan FC backend and the evaluation protocol
# ---------------------------------------------------------------------------
def switch_op_diffs(dev) -> dict:
    """Each switch arithmetic function on the card against the same call on
    the CPU over every integer 1..2^22, the powers of two 2^0..2^30 and
    random floats (dividends and factors a permutation of the same): the
    count of operands whose results differ, per function."""
    from repro_torch.core import arith
    rng = np.random.default_rng(0)
    g = np.concatenate([np.arange(1, 2 ** 22 + 1, dtype=np.float32),
                        np.ldexp(np.float32(1), np.arange(31)).astype(np.float32),
                        np.exp(rng.uniform(0, np.log(2.0 ** 40), 200_000)).astype(np.float32),
                        rng.uniform(-2, 1, 1000).astype(np.float32)])
    x, a = torch.from_numpy(g), torch.from_numpy(rng.permutation(g))
    lam = torch.tensor([10.0, 1.0, 0.1, 1.0 / 60.0])
    dt = torch.from_numpy(rng.exponential(3.0, (4096, 1)).astype(np.float32))
    cases = {"shift_div": (arith.shift_div, (a, x)), "shift_mul": (arith.shift_mul, (a, x)),
             "mathunit_square": (arith.mathunit_square, (x,)),
             "mathunit_sqrt": (arith.mathunit_sqrt, (x,)),
             "quantized_decay": (arith.quantized_decay, (lam, dt)),
             "frexp_exponent": (lambda v: torch.frexp(v)[1], (x,))}
    out = {}
    for name, (fn, args) in cases.items():
        want = fn(*args)
        got = fn(*(t.to(dev) for t in args)).cpu()
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        out[name] = int((~same).sum())
    return out


def phase_switch(dev, log):
    """process_serial(mode="switch") on the card against the same call on the
    CPU: 2048 packets of a mirai trace at n_slots=8192, features and every
    table (round-robin counters included) bit for bit; the card's ms a
    packet; each switch function on the card against the CPU.  Returns the
    trace and the CPU's (state, features) for phase partition."""
    from repro_torch.core import init_state, process_serial
    from repro_torch.traffic import synth_trace, to_torch
    tr = synth_trace("mirai", n_train=64, n_benign_eval=1024, n_attack=1024,
                     seed=0)["eval"]
    out, secs = {}, {}
    for where in ("cuda", "cpu"):
        st = init_state(8192, device=where)
        pk = to_torch(tr, where)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, f = process_serial(st, pk, mode="switch")
        torch.cuda.synchronize()
        secs[where] = time.perf_counter() - t0
        out[where] = (st, f)
    (st_g, f_g), (st_c, f_c) = out["cuda"], out["cpu"]
    diffs = {"features": max_abs(f_g.cpu(), f_c)}
    diffs.update({f"{g}/{k}": max_abs(st_g[g][k].cpu(), st_c[g][k])
                  for g in ("uni", "bi") for k in st_c[g]})
    ops = switch_op_diffs(dev)
    n = len(tr["ts"])
    rec = {"phase": "switch", "packets": n, "n_slots": 8192,
           "card_ms_per_packet": secs["cuda"] / n * 1e3,
           "cpu_ms_per_packet": secs["cpu"] / n * 1e3,
           "max_abs_diff": diffs, "op_mismatches": ops,
           "rr_max": int(st_g["bi"]["rr"].max())}
    emit(rec, log)
    bitwise = torch.equal(f_g.cpu(), f_c) and all(
        torch.equal(st_g[g][k].cpu(), st_c[g][k]) for g in ("uni", "bi") for k in st_c[g])
    if not bitwise or any(ops.values()):
        raise RuntimeError(f"switch: card and CPU differ: {diffs}; ops {ops}")
    return tr, out["cpu"]


def device_ms_per_call(fn, reps: int) -> dict:
    """Device time (the events that ran on the card) and torch sort calls
    per call of ``fn``, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    sorts = sum(e.count for e in prof.key_averages() if e.key == "aten::sort")
    return {"device_ms": sum(us for us, _ in events.values()) / reps * 1e-3,
            "device_launches": sum(c for _, c in events.values()) / reps,
            "sorts": sorts / reps}


def phase_scan(dev, pk, log) -> None:
    """compute_features(backend="scan") on the dense main path's chunk (phase
    fc's 8192 packets, n_slots=8192, fresh tables) against backend="cuda"
    (fc_full, bit for bit the serial oracle) in the JAX package's scan
    envelope (tests/test_backends.py); the record-sampled path against the
    full path's rows and state; device ms a chunk and sorts a call."""
    from repro_torch.core import clone_state, compute_features, init_state
    from repro_torch.core.backends import compute_features_sampled
    from repro_torch.core.records import epoch_gather
    from repro_torch.core.state import FEATURE_NAMES
    st0 = init_state(8192, device=dev)
    st_k, f_k = compute_features(clone_state(st0), pk, backend="cuda")
    st_s, f_s = compute_features(clone_state(st0), pk, backend="scan")
    want, got = f_k.double(), f_s.double()
    ok = (got - want).abs() <= 1.0 + 1e-3 * want.abs()
    pcc = torch.tensor([n.endswith(":pcc") for n in FEATURE_NAMES], device=dev)
    state_ok = all(torch.allclose(st_s[g][k].double(), st_k[g][k].double(),
                                  rtol=1e-3, atol=1.0)
                   for g in ("uni", "bi") for k in st_k[g])
    idx, _ = epoch_gather(pk["ts"].shape[0], 1024, 0, device=dev)
    st_x, f_x = compute_features_sampled(clone_state(st0), pk, idx, backend="scan")
    sampled_bitwise = torch.equal(f_x, f_s[idx]) and states_equal(st_x, st_s)
    st_w = clone_state(st0)
    rec = {"phase": "scan", "packets": int(pk["ts"].shape[0]), "n_slots": 8192,
           "envelope_share": float(ok.double().mean()),
           "non_pcc_in_envelope": bool(ok[:, ~pcc].all()),
           "max_abs_diff_non_pcc": max_abs(f_s[:, ~pcc], f_k[:, ~pcc]),
           "state_in_envelope": state_ok, "sampled_bitwise": sampled_bitwise,
           "full": {**device_ms_per_call(
                        lambda: compute_features(st_w, pk, backend="scan"), 20),
                    "call_ms": cuda_ms(lambda: compute_features(st_w, pk, backend="scan"),
                                       20)},
           "sampled": {**device_ms_per_call(
                           lambda: compute_features_sampled(st_w, pk, idx, backend="scan"),
                           20),
                       "call_ms": cuda_ms(lambda: compute_features_sampled(
                           st_w, pk, idx, backend="scan"), 20),
                       "records": int(idx.shape[0])},
           "fc_full": device_ms_per_call(lambda: compute_features(st_w, pk, backend="cuda"),
                                         20)}
    emit(rec, log)
    if not (rec["non_pcc_in_envelope"] and rec["envelope_share"] >= 0.995
            and state_ok and sampled_bitwise):
        raise RuntimeError(f"scan: outside the JAX envelope against fc_full: {rec}")


def phase_scan_main(data, main: dict, main_trace: dict, log) -> None:
    """The detection service on backend="scan" (the fused step through the
    record-sampled path) over the dense main path's traffic, launch counts
    zeroed just before and read just after: no fc_full launch, the KitNET
    kernels as on the main path; eval pps and the device's busy share beside
    phase main's, and AUC."""
    from repro_torch.detection.metrics import auc
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.serving import DetectionService
    svc = DetectionService(backend="scan")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.observe_stream(data["train"], chunk=8192)
    svc.fit(seed=0, fpr=0.01)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eval_start = svc.pkt_count
    t0 = time.perf_counter()
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=8192)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    n_eval = len(data["eval"]["ts"])
    if launches["fc_full"] != 0:
        raise RuntimeError("scan path launched fc_full")
    check_kitnet_launches(launches, -(-n_eval // 8192), "scan path")
    want_idx = np.arange(svc.epoch - 1 - eval_start % svc.epoch, n_eval,
                         svc.epoch) + eval_start
    if not np.array_equal(idx, want_idx):
        raise RuntimeError("scan path record indices are not the epoch closers")
    if not (np.isfinite(scores).all() and scores.shape == idx.shape):
        raise RuntimeError("scan path scores are not finite or misshapen")
    labels = data["eval"]["label"][idx - eval_start]
    trace = trace_eval(svc, data["eval"], eval_s, KERNELS)
    emit({"phase": "scan_main", "backend": "scan", "observe_fit_s": fit_s,
          "eval_s": eval_s, "eval_pps": n_eval / eval_s,
          "eval_pps_more_passes": eval_passes(svc, data["eval"]),
          "auc": auc(scores, labels), "records": int(len(scores)),
          "launches": launches,
          "busy_share_untraced": trace["busy_share_untraced"],
          "device_busy_s": trace["device_busy_s"],
          "device_launches_per_chunk": trace["device_launches_per_chunk"],
          "top_device_us": trace["top_device_us"],
          "main": {"eval_pps": main["eval_pps"], "auc": main["auc"],
                   "busy_share_untraced": main_trace["busy_share_untraced"],
                   "device_launches_per_chunk": main_trace["device_launches_per_chunk"]}},
         log)


def phase_partition(dev, data, pk, main: dict, main_trace: dict, switch_tr,
                    switch_cpu, log) -> dict:
    """The partitioned FC backends.  The service on backend="bucketed" at 4
    and 16 buckets over the dense main path's traffic, launch counts zeroed
    just before and read just after (no fc_full, the KitNET kernels as on
    the main path): record indices the epoch closers, finite scores, AUC,
    eval pps, and device launches a chunk over the first 8 eval chunks,
    beside phase main's; bucketed on
    phase fc's chunk against fc_full in the JAX package's scan envelope, its
    device ms and sorts a call.  Then backend="sharded" on phase switch's
    2048 mirai packets at n_slots=8192: exact mode at 4 and 16 shards
    against the card's serial oracle, switch mode at 4 shards against the
    CPU's serial oracle (phase switch's run), features and every table bit
    for bit; card ms a packet of each.  Returns what phase mesh holds its
    placed runs against: each bucketed service with its post-fit tables
    and its eval results, and the card's serial run."""
    from repro_torch.core import (clone_state, compute_features, init_state,
                                  process_serial)
    from repro_torch.core.state import FEATURE_NAMES
    from repro_torch.detection.metrics import auc
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.serving import DetectionService
    from repro_torch.traffic import to_torch
    rec = {"phase": "partition", "main": {
        "eval_pps": main["eval_pps"], "auc": main["auc"],
        "device_launches_per_chunk": main_trace["device_launches_per_chunk"]}}
    n_eval = len(data["eval"]["ts"])
    chunks = -(-n_eval // 8192)
    st0 = init_state(8192, device=dev)
    _, f_k = compute_features(clone_state(st0), pk, backend="cuda")
    pcc = torch.tensor([n.endswith(":pcc") for n in FEATURE_NAMES], device=dev)
    unplaced = {}
    for S in (4, 16):
        t_part = time.perf_counter()
        svc = DetectionService(backend="bucketed", buckets=S, device=dev)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.observe_stream(data["train"], chunk=8192)
        svc.fit(seed=0, fpr=0.01)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        eval_start = svc.pkt_count
        snap = clone_state(svc.state)
        t0 = time.perf_counter()
        idx, scores, alarms = svc.process_stream(data["eval"], chunk=8192)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        unplaced[S] = {"svc": svc, "snap": snap, "count": eval_start,
                       "result": (idx, scores, alarms), "eval_pps": n_eval / eval_s}
        launches = launch_counts()
        if launches["fc_full"] != 0:
            raise RuntimeError(f"bucketed S={S} launched fc_full")
        check_kitnet_launches(launches, chunks, f"bucketed S={S}")
        want_idx = np.arange(svc.epoch - 1 - eval_start % svc.epoch, n_eval,
                             svc.epoch) + eval_start
        if not np.array_equal(idx, want_idx):
            raise RuntimeError(f"bucketed S={S}: record indices are not the epoch closers")
        if not (np.isfinite(scores).all() and scores.shape == idx.shape):
            raise RuntimeError(f"bucketed S={S}: scores not finite or misshapen")
        labels = data["eval"]["label"][idx - eval_start]
        more = eval_passes(svc, data["eval"])
        # the profiler's own cost grows with the events it keeps (about
        # 1,000 launches a chunk here): trace the first 8 chunks only,
        # against their own untraced time
        sub = {k: v[:8 * 8192] for k, v in data["eval"].items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.process_stream(sub, chunk=8192)
        torch.cuda.synchronize()
        trace = trace_eval(svc, sub, time.perf_counter() - t0, KERNELS)
        st_b, f_b = compute_features(clone_state(st0), pk, backend="bucketed", buckets=S)
        want, got = f_k.double(), f_b.double()
        ok = (got - want).abs() <= 1.0 + 1e-3 * want.abs()
        st_w = clone_state(st0)
        rec[f"bucketed_{S}"] = {
            "observe_fit_s": fit_s, "eval_s": eval_s, "eval_pps": n_eval / eval_s,
            "eval_pps_more_passes": more,
            "auc": auc(scores, labels), "records": int(len(scores)),
            "alarms": int(alarms.sum()), "launches": launches,
            "busy_share_untraced": trace["busy_share_untraced"],
            "device_launches_per_chunk": trace["device_launches_per_chunk"],
            "traced_chunks": trace["chunks"], "top_device_us": trace["top_device_us"],
            "fc_chunk": {"envelope_share": float(ok.double().mean()),
                         "non_pcc_in_envelope": bool(ok[:, ~pcc].all()),
                         **device_ms_per_call(lambda: compute_features(
                             st_w, pk, backend="bucketed", buckets=S), 10)},
            "seconds": time.perf_counter() - t_part}
        if not (rec[f"bucketed_{S}"]["fc_chunk"]["non_pcc_in_envelope"]
                and rec[f"bucketed_{S}"]["fc_chunk"]["envelope_share"] >= 0.995):
            raise RuntimeError(f"bucketed S={S}: outside the scan envelope against "
                               f"fc_full: {rec[f'bucketed_{S}']['fc_chunk']}")

    def run(where, backend, mode, **kw):
        st = init_state(8192, device=where)
        p = to_torch(switch_tr, where)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, f = compute_features(st, p, backend=backend, mode=mode, **kw)
        torch.cuda.synchronize()
        return st, f, (time.perf_counter() - t0) / len(switch_tr["ts"]) * 1e3

    def same(a, b):
        (st_a, f_a), (st_b, f_b) = a, b
        return torch.equal(f_a.cpu(), f_b.cpu()) and all(
            torch.equal(st_a[g][k].cpu(), st_b[g][k].cpu())
            for g in ("uni", "bi") for k in st_b[g])

    t_part = time.perf_counter()
    st_s, f_s, ms = run(dev, "serial", "exact")
    sharded = {"packets": len(switch_tr["ts"]), "n_slots": 8192,
               "serial_exact_card_ms_per_packet": ms}
    checks = {}
    for S in (4, 16):
        st_h, f_h, ms = run(dev, "sharded", "exact", shards=S)
        sharded[f"exact_{S}_card_ms_per_packet"] = ms
        checks[f"exact_{S}_bitwise_card_serial"] = same((st_h, f_h), (st_s, f_s))
    st_h, f_h, ms = run(dev, "sharded", "switch", shards=4)
    sharded["switch_4_card_ms_per_packet"] = ms
    checks["switch_4_bitwise_cpu_serial"] = same((st_h, f_h), switch_cpu)
    rec["sharded"] = {**sharded, **checks, "seconds": time.perf_counter() - t_part}
    emit(rec, log)
    if not all(checks.values()):
        raise RuntimeError(f"sharded: not bit for bit: {checks}")
    return {"bucketed": unplaced, "serial": (st_s, f_s),
            "sharded_4_ms_per_packet": sharded["exact_4_card_ms_per_packet"]}


# ---------------------------------------------------------------------------
# the multi-tenant engine
# ---------------------------------------------------------------------------
def same_results(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def solo_service(net, threshold: float, **kw):
    """A service on the card with a fitted net and threshold and fresh
    tables: a tenant's solo reference."""
    from repro_torch.serving import DetectionService
    s = DetectionService(threshold=threshold, **kw)
    s.net = net
    return s


def engine_fc_case(dev, data) -> dict:
    """The tenant-batched fc_full on tenants {0, 2, 3} of a 4-tenant pool at
    n_slots=8192 (each tenant warmed on its own 8192 training packets), each
    lane an 8192-packet chunk of the eval stream at its own offset: equal to
    its plain version (process_serial lane by lane) and to three
    single-state launches, bit for bit, features and every pool table.
    Device ms of the batched launch against three single launches, and the
    device kernels a batched call runs (profiler): each of fc_full's six
    once a call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.state import init_state_stacked, tenant_view
    from repro_torch.kernels.feature_update import (feature_update_full,
                                                    feature_update_full_tenants,
                                                    feature_update_full_tenants_ref)
    from repro_torch.traffic import to_torch
    n_slots, chunk, tids = 8192, 8192, [0, 2, 3]
    pool = init_state_stacked(4, n_slots, device=dev)
    for t in range(4):
        feature_update_full(tenant_view(pool, t), to_torch(
            {k: v[t * chunk:(t + 1) * chunk] for k, v in data["train"].items()}, dev))
    offsets = [0, 12 * chunk, 25 * chunk]
    pk = to_torch({k: np.stack([v[o:o + chunk] for o in offsets])
                   for k, v in data["eval"].items()}, dev)

    def copy(p):
        return {g: {k: v.clone() for k, v in p[g].items()} for g in p}

    p_k, p_p, p_s = copy(pool), copy(pool), copy(pool)
    _, f_k = feature_update_full_tenants(p_k, tids, pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, f_p = feature_update_full_tenants_ref(p_p, tids, pk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    lanes = [{k: v[lane] for k, v in pk.items()} for lane in range(len(tids))]
    f_s = torch.stack([feature_update_full(tenant_view(p_s, t), lanes[lane])[1]
                       for lane, t in enumerate(tids)])
    tables = [(g, k) for g in ("uni", "bi") for k in pool[g]]
    err = max([max_abs(f_k, f_p)] + [max_abs(p_k[g][k], p_p[g][k]) for g, k in tables])
    if not (torch.equal(f_k, f_p) and all(torch.equal(p_k[g][k], p_p[g][k])
                                          for g, k in tables)):
        raise RuntimeError(f"engine: tenant-batched fc_full differs from its plain "
                           f"version (max abs err {err})")
    if not (torch.equal(f_k, f_s) and all(torch.equal(p_k[g][k], p_s[g][k])
                                          for g, k in tables)):
        raise RuntimeError("engine: tenant-batched fc_full differs from single launches")
    if not all(torch.equal(p_k[g][k][1], pool[g][k][1]) for g, k in tables):
        raise RuntimeError("engine: tenant-batched fc_full wrote a tenant outside the batch")

    def batched():
        feature_update_full_tenants(p_k, tids, pk)

    def singles():
        for lane, t in enumerate(tids):
            feature_update_full(tenant_view(p_s, t), lanes[lane])

    reps = 50
    single = timed(singles, reps, FC_NAMES)
    # the profiler's ms is per launch of each kernel, three launches a call
    single["three_ms"] = single["ms"] * (3 if single["ms_from"] == "profiler" else 1)
    batched()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            batched()
        torch.cuda.synchronize()
    events = device_events(prof)
    per_call = {name: sum(c for key, (_, c) in events.items() if name in key) / reps
                for name in FC_NAMES}
    if any(v != 1 for v in per_call.values()):
        raise RuntimeError(f"engine: a batched fc_full call ran {per_call} of the FC "
                           "kernels, not each once")
    return {"tenants": 4, "lanes": tids, "packets_per_lane": chunk, "n_slots": n_slots,
            "offsets": offsets, "bitwise_plain": True, "bitwise_single_launches": True,
            "max_abs_err": err, "plain_ms": plain_ms,
            "batched": timed(batched, reps, FC_NAMES),
            "three_single": single,
            "batched_device": device_ms_per_call(batched, reps),
            "three_single_device": device_ms_per_call(singles, reps),
            "fc_kernels_per_batched_call": per_call,
            "device_launches_per_batched_call": sum(c for _, c in events.values()) / reps}


def engine_run(svc, traces: dict, **kw):
    """A fresh engine from ``svc`` (4 tenants, chunk 8192, queue depth 4
    unless ``kw`` says otherwise), one tenant a trace, through ``run``;
    returns the engine, its tenants and the wall seconds of the whole."""
    from repro_torch.serving import DetectionEngine
    cfg = dict(n_tenants=4, chunk=8192, queue_depth=4)
    cfg.update(kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = DetectionEngine.from_service(svc, **cfg)
    tids = [eng.add_tenant() for _ in traces]
    eng.run(dict(zip(tids, traces)))
    torch.cuda.synchronize()
    return eng, tids, time.perf_counter() - t0


def check_tenants(eng, tids, traces, solo_kw: dict, what: str) -> None:
    """Each tenant's results and end state equal its own solo service's
    process_stream on the card, bit for bit (fresh tables both times)."""
    solos = {}
    for t, tr in zip(tids, traces):
        key = id(tr)
        if key not in solos:
            s = solo_service(**solo_kw)
            solos[key] = (s.process_stream(tr, chunk=eng.chunk), s.state)
        want, end = solos[key]
        if not same_results(eng.results(t), want):
            raise RuntimeError(f"engine {what}: tenant {t}'s results differ from "
                               "its solo process_stream")
        got = eng.pool.read(t)
        if not (states_equal(got, end)
                and torch.equal(got.get("evict_age", torch.zeros(())).cpu(),
                                end.get("evict_age", torch.zeros(())).cpu())):
            raise RuntimeError(f"engine {what}: tenant {t}'s end state differs from "
                               "its solo process_stream")


def phase_engine(dev, data, svc, sketch_svc, log) -> dict:
    """The multi-tenant engine on the card with phase main's fitted net (and
    phase sketch_main's for the sketch pool): the tenant-batched fc_full
    against its plain version and single launches; 4 tenants each fed the
    dense cell's 262,144 eval packets through run (chunk 8192, epoch 1024,
    n_slots 8192, queue depth 4), counts zeroed just before and read just
    after (one fc_full and one kitnet_score launch a batch of 4 lanes),
    each tenant equal to its solo process_stream bit for bit; aggregate
    pps, worst-tenant p99, slot collisions (the device count equal to the
    host count of each chunk; both timed), the device's busy share and
    launches a batched call (profiler), the single stream's eval pps and
    the ratio of the two over alternating rounds; 4 tenants on 4 attacks
    (16,384 packets each) and 2 tenants on the sketch cell's layout, each
    equal to its solo run bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.state import slot_collisions, slot_collisions_lanes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.traffic import synth_trace, to_torch
    fc_case = engine_fc_case(dev, data)
    ev = {k: v for k, v in data["eval"].items() if k != "label"}
    n_eval = len(ev["ts"])
    dense_kw = dict(net=svc.net, threshold=svc.threshold)

    # ---- 4 tenants on the dense cell's eval stream ----
    engine_run(svc, [ev] * 4)                                   # warm-up
    reset_launch_counts()
    eng, tids, wall = engine_run(svc, [ev] * 4)
    launches = launch_counts()
    batches = -(-n_eval // 8192)                # each a batch of 4 lanes
    if launches["fc_full"] != batches or launches["kitnet_score"] != batches:
        raise RuntimeError(f"engine: {launches} for {batches} batches of 4 lanes; "
                           "each batch must be one fc_full and one kitnet_score launch")
    check_tenants(eng, tids, [ev] * 4, dense_kw, "dense")
    stats = eng.stats()
    per = stats["tenants"]
    collisions = sum(v["slot_collisions"] for v in per.values())

    solo = solo_service(**dense_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo.process_stream(ev, chunk=8192)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    te, ts = [], []
    for _ in range(3):
        te.append(engine_run(svc, [ev] * 4)[2])
        s = solo_service(**dense_kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.process_stream(ev, chunk=8192)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ratio = (4 * n_eval / min(te)) / (n_eval / min(ts))
    # the collision telemetry: the engine's device count of a batch's 4
    # lanes against the host count (numpy, JAX's design) of each lane,
    # equal per tenant and timed; and the staging of a batch's packets
    chunks = [{k: v[i:i + 8192] for k, v in ev.items()} for i in range(0, n_eval, 8192)]
    t0 = time.perf_counter()
    host_counts = [slot_collisions(c, 8192)["total"] for c in chunks]
    host_collisions_ms = (time.perf_counter() - t0) / len(chunks) * 1e3
    if any(v["slot_collisions"] != sum(host_counts) for v in per.values()):
        raise RuntimeError(f"engine: device slot collisions {collisions} differ from "
                           f"the host count, {sum(host_counts)} a tenant")
    t0 = time.perf_counter()
    staged = [to_torch({k: np.stack([v] * 4) for k, v in c.items()}, dev) for c in chunks]
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) / len(chunks) * 1e3
    t0 = time.perf_counter()
    for pk in staged:
        slot_collisions_lanes(pk, 8192)
    torch.cuda.synchronize()
    collisions_ms = (time.perf_counter() - t0) / len(chunks) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = engine_run(svc, [ev] * 4)[2]
    events = device_events(prof)
    busy_s = sum(us for us, _ in events.values()) * 1e-6
    launched = sum(c for _, c in events.values())

    # ---- 4 tenants on 4 attacks ----
    attacks = ("syn_dos", "ssdp_flood", "goldeneye", "fuzzing")
    iso = [{k: v for k, v in synth_trace(a, n_train=64, n_benign_eval=8192,
                                         n_attack=8192, seed=20 + i)["eval"].items()
            if k != "label"} for i, a in enumerate(attacks)]
    eng_i, tids_i, _ = engine_run(svc, iso)
    check_tenants(eng_i, tids_i, iso, dense_kw, "isolation")

    # ---- 2 tenants on the sketch cell's layout ----
    reset_launch_counts()
    sk_traces = [{k: v[o:o + 16384] for k, v in ev.items()} for o in (0, 131072)]
    eng_s, tids_s, _ = engine_run(sketch_svc, sk_traces, n_tenants=2)
    sk_launches = launch_counts()
    if sk_launches["sketch_update"] != 2 * 2 or sk_launches["fc_full"]:
        raise RuntimeError(f"engine sketch: {sk_launches}; the sketch pool runs "
                           "sketch_update once a lane a batch")
    check_tenants(eng_s, tids_s, sk_traces,
                  dict(net=sketch_svc.net, threshold=sketch_svc.threshold,
                       n_slots=4096, state_backend="sketch", state_kw={"rows": 2}),
                  "sketch")
    rec = {"phase": "engine", "fc_tenants": fc_case,
           "run": {"tenants": 4, "eval_pkts_per_tenant": n_eval, "chunk": 8192,
                   "epoch": svc.epoch, "n_slots": 8192, "queue_depth": 4,
                   "pool_mib": sum(t.numel() * t.element_size()
                                   for g in ("uni", "bi")
                                   for t in eng.pool.stacked[g].values()) / 2 ** 20,
                   "wall_s": wall, "agg_pps": 4 * n_eval / min(te),
                   "agg_pps_first_run": 4 * n_eval / wall,
                   "agg_pps_stats": stats["aggregate"]["pps"],
                   "agg_pps_rounds": [4 * n_eval / t for t in te],
                   "host_ms_per_batch": {"wall": min(te) / batches * 1e3,
                                         "slot_collisions_device_4_lanes": collisions_ms,
                                         "slot_collisions_host_4_lanes":
                                             4 * host_collisions_ms,
                                         "stage_4_lanes": stage_ms},
                   "worst_p99_ms": max(v["p99_ms"] for v in per.values()),
                   "p50_ms": {t: v["p50_ms"] for t, v in per.items()},
                   "slot_collisions": collisions, "records": {
                       t: v["records"] for t, v in per.items()},
                   "alarms": {t: v["alarms"] for t, v in per.items()},
                   "launches": launches, "batches": batches, "bitwise_solo": True},
           "single_stream": {"eval_s": single_s, "eval_pps": n_eval / min(ts),
                             "eval_pps_first_run": n_eval / single_s,
                             "eval_pps_rounds": [n_eval / t for t in ts],
                             "wall_ms_per_chunk": min(ts) / batches * 1e3},
           "interleaved_engine_ratio": ratio,
           "trace": {"traced_s": traced, "device_busy_s": busy_s,
                     "busy_share_traced": busy_s / traced,
                     "busy_share_untraced": busy_s / min(te),
                     "device_launches": launched,
                     "device_launches_per_batched_call": launched / batches,
                     "top_device_us": dict(sorted(((k, us) for k, (us, _) in events.items()),
                                                  key=lambda kv: -kv[1])[:10])},
           "isolation": {"attacks": attacks, "packets_each": 16384, "bitwise_solo": True},
           "sketch_pool": {"tenants": 2, "n_slots": 4096, "rows": 2,
                           "packets_each": 16384, "launches": sk_launches,
                           "bitwise_solo": True}}
    emit(rec, log)
    return rec


# ---------------------------------------------------------------------------
# the Peregrine path placed over a mesh
# ---------------------------------------------------------------------------
def mesh_layouts() -> dict:
    """Four places on cuda:0, and a place a card (at most four) where the
    host has two or more cards."""
    out = {"one_card_4_places": [torch.device("cuda", 0)] * 4}
    n = torch.cuda.device_count()
    if n > 1:
        out[f"{min(n, 4)}_cards"] = [torch.device("cuda", i) for i in range(min(n, 4))]
    return out


def mesh_pass(fn, places):
    """fn() under ``flow_mesh(devices=places)`` (unplaced for None), launch
    and transfer counts zeroed just before: (result, wall s, launches,
    bytes moved)."""
    import contextlib
    from repro_torch.distributed.sharding import (flow_mesh, reset_transfer_counts,
                                                  transfer_counts)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    reset_launch_counts()
    reset_transfer_counts()
    sync()
    t0 = time.perf_counter()
    with flow_mesh(devices=places) if places else contextlib.nullcontext():
        out = fn()
        sync()
    return out, time.perf_counter() - t0, launch_counts(), transfer_counts()


def same_bits(a, b) -> bool:
    return all(np.asarray(x).dtype == np.asarray(y).dtype
               and np.asarray(x).shape == np.asarray(y).shape
               and np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(a, b))


def mesh_service_case(svc, snap, count: int, ev: dict, places, want, kernel: str,
                      what: str) -> dict:
    """A fitted service's eval stream from its post-fit tables, unplaced,
    then placed: each pass's indices, scores and alarms
    the bits of ``want``; each placed pass launches ``kernel`` and
    kitnet_score once a chunk (fc_full none unless it is ``kernel``); eval
    pps of each pass, bytes between places a chunk, and device launches a
    chunk over the first 2 chunks, placed and unplaced (profiler)."""
    from repro_torch.core import clone_state
    from repro_torch.kernels import KERNELS
    n = len(ev["ts"])
    chunks = -(-n // 8192)

    def run(pkts):
        def go():
            svc.state, svc.pkt_count = clone_state(snap), count
            return svc.process_stream(pkts, chunk=8192)
        return go

    passes = []
    for where in (None, places):
        out, secs, launches, moved = mesh_pass(run(ev), where)
        if not same_bits(out, want):
            raise RuntimeError(f"mesh {what}: {'placed' if where else 'unplaced'} "
                               "results are not the unplaced run's bits")
        if where and (launches["kitnet_score"] != chunks
                      or launches[kernel] != (chunks if kernel != "fc_full" else 0)
                      or (kernel != "fc_full" and launches["fc_full"])):
            raise RuntimeError(f"mesh {what}: placed launches {launches}")
        passes.append({"placed": bool(where), "eval_pps": n / secs,
                       "launches": launches, "moved": moved})
    t_case = time.perf_counter()
    sub = {k: v[:2 * 8192] for k, v in ev.items()}
    launches_per_chunk = {}
    for label, where in (("unplaced", None), ("placed", places)):
        _, secs, _, _ = mesh_pass(run(sub), where)

        def traced():
            svc.state, svc.pkt_count = clone_state(snap), count
            return trace_eval(svc, sub, secs, KERNELS)

        launches_per_chunk[label] = mesh_pass(traced, where)[0]["device_launches_per_chunk"]
    placed = [p for p in passes if p["placed"]]
    return {"eval_pps_placed": [p["eval_pps"] for p in placed],
            "eval_pps_unplaced": [p["eval_pps"] for p in passes if not p["placed"]],
            "device_launches_per_chunk": launches_per_chunk,
            "bytes_between_places_per_chunk":
                placed[0]["moved"]["between_places"] / chunks,
            "launches_placed": placed[0]["launches"], "bitwise_unplaced": True,
            "seconds": time.perf_counter() - t_case}


def mesh_engine_case(svc, ev: dict, places, want: dict) -> dict:
    """4 tenants each fed the eval stream through ``DetectionEngine.run``,
    built unplaced and under the mesh in turns (u, p, p, u): each tenant's
    results the unplaced engine's bits (``want``: results and end tables);
    the placed pool's tables on their places, never moved; one fc_full and
    one kitnet_score launch a place a batch; aggregate pps, bytes between
    places and from the host a batch, device launches a batch (profiler,
    the first 2 batches)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.state import tenant_view
    from repro_torch.distributed.sharding import flow_mesh
    from repro_torch.serving import DetectionEngine
    t_case = time.perf_counter()
    n = len(ev["ts"])
    batches = -(-n // 8192)
    D = len(places)

    def run(where, pkts=ev):
        """Build (under the mesh when placed: the pool takes its places
        then) and run the engine; a placed pool's tables must lie on their
        places and stay where they are."""
        eng = DetectionEngine.from_service(svc, n_tenants=4, chunk=8192,
                                           queue_depth=4)
        tids = [eng.add_tenant() for _ in range(4)]
        homes = [tenant_view(eng.pool.stacked, t)["uni"]["w"] for t in tids]
        ptrs = [w.data_ptr() for w in homes]
        if where and [w.device for w in homes] != [places[t % D] for t in tids]:
            raise RuntimeError("mesh engine: a tenant's tables are not on its place")
        eng.run(dict(zip(tids, [pkts] * 4)))
        if ptrs != [tenant_view(eng.pool.stacked, t)["uni"]["w"].data_ptr()
                    for t in tids]:
            raise RuntimeError("mesh engine: a tenant's tables moved during run")
        return eng, tids

    passes = []
    for where in (None, places, places, None):
        (eng, tids), secs, launches, moved = mesh_pass(lambda: run(where), where)
        for t in tids:
            got = eng.results(t)
            end = {g: {k: v.cpu() for k, v in eng.pool.read(t)[g].items()}
                   for g in ("uni", "bi")}
            if not (same_bits(got, want["results"][t])
                    and states_equal(end, want["states"][t])):
                raise RuntimeError(f"mesh engine: tenant {t} is not the unplaced "
                                   "engine's bits")
        if where and not (launches["fc_full"] == launches["kitnet_score"]
                          == batches * len({t % D for t in tids})):
            raise RuntimeError(f"mesh engine: {launches} for {batches} batches over "
                               f"{D} places")
        passes.append({"placed": bool(where), "agg_pps": 4 * n / secs,
                       "launches": launches, "moved": moved})
    with flow_mesh(devices=places):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(places, {k: v[:2 * 8192] for k, v in ev.items()})
            torch.cuda.synchronize()
    launched = sum(c for _, c in device_events(prof).values()) / 2
    placed = [p for p in passes if p["placed"]]
    return {"agg_pps_placed": [p["agg_pps"] for p in placed],
            "agg_pps_unplaced": [p["agg_pps"] for p in passes if not p["placed"]],
            "device_launches_per_batch_placed": launched,
            "bytes_between_places_per_batch": placed[0]["moved"]["between_places"] / batches,
            "bytes_host_to_places_per_batch": placed[0]["moved"]["host_to_place"] / batches,
            "launches_placed": placed[0]["launches"], "batches": batches,
            "bitwise_unplaced": True, "seconds": time.perf_counter() - t_case}


def phase_mesh(dev, data, svc, sketch_svc, part: dict, switch_tr, log) -> None:
    """The Peregrine path placed over a mesh (``flow_mesh(devices=...)``):
    four places on cuda:0, and a place a card where the host has two or
    more (else the record says the cross-card path was not run).  On the
    main traffic: the bucketed service at S=4 and 16 from phase
    partition's post-fit tables, bit for bit with its unplaced eval
    (indices and score bits); sharded at S=4 on phase switch's 2,048
    packets, bit for bit with the card's serial run of phase partition; the
    sketch service (phase sketch_main's, from its tables now) under the
    mesh, unchanged; 4 tenants through ``DetectionEngine.run`` from phase
    main's service, bit for bit with the unplaced engine.  Each case: eval
    or aggregate pps placed and unplaced, device launches a chunk, bytes
    between places a chunk."""
    from repro_torch.core import clone_state, compute_features, init_state
    from repro_torch.traffic import to_torch
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    ev = {k: v for k, v in data["eval"].items() if k != "label"}
    rec = {"phase": "mesh", "layouts": {}}
    sk_snap, sk_count = clone_state(sketch_svc.state), sketch_svc.pkt_count
    sk_want = sketch_svc.process_stream(ev, chunk=8192)
    want_eng = {"results": {}, "states": {}}
    eng, tids, _ = engine_run(svc, [ev] * 4)
    for t in tids:
        want_eng["results"][t] = eng.results(t)
        want_eng["states"][t] = {g: {k: v.cpu() for k, v in eng.pool.read(t)[g].items()}
                                 for g in ("uni", "bi")}
    del eng
    st_s, f_s = part["serial"]
    n_sh = len(switch_tr["ts"])
    pk_sh = to_torch(switch_tr, dev)
    for name, places in mesh_layouts().items():
        t_lay = time.perf_counter()
        out = {"places": [str(d) for d in places]}
        for S, b in part["bucketed"].items():
            out[f"bucketed_{S}"] = mesh_service_case(
                b["svc"], b["snap"], b["count"], ev, places, b["result"], "fc_full",
                f"bucketed S={S}")
            out[f"bucketed_{S}"]["eval_pps_partition"] = b["eval_pps"]
        t_case = time.perf_counter()
        (st_h, f_h), secs, launches, moved = mesh_pass(
            lambda: compute_features(init_state(8192, device=dev), pk_sh,
                                     backend="sharded", shards=4), places)
        if not (torch.equal(f_h, f_s) and states_equal(st_h, st_s)):
            raise RuntimeError(f"mesh sharded ({name}): not bit for bit with serial")
        few = {k: v[:4] for k, v in pk_sh.items()}
        per_packet = {}
        for label, where in (("unplaced", None), ("placed", places)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                mesh_pass(lambda: compute_features(init_state(8192, device=dev), few,
                                                   backend="sharded", shards=4), where)
            per_packet[label] = sum(c for _, c in device_events(prof).values()) / 4
        out["sharded_4"] = {"packets": n_sh, "ms_per_packet_placed": secs / n_sh * 1e3,
                            "ms_per_packet_unplaced_partition":
                                part["sharded_4_ms_per_packet"],
                            "device_launches_per_packet": per_packet,
                            "bytes_between_places_per_call": moved["between_places"],
                            "bitwise_card_serial": True,
                            "seconds": time.perf_counter() - t_case}
        out["sketch"] = mesh_service_case(sketch_svc, sk_snap, sk_count, ev, places,
                                          sk_want, "sketch_update", "sketch")
        out["engine_4_tenants"] = mesh_engine_case(svc, ev, places, want_eng)
        out["seconds"] = time.perf_counter() - t_lay
        rec["layouts"][name] = out
    if torch.cuda.device_count() < 2:
        rec["cross_card"] = (f"not run: {torch.cuda.device_count()} card visible; "
                             "four places shared cuda:0")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec, log)


def phase_eval(data, net, log) -> None:
    """The paper's evaluation protocol on the card, launch counts zeroed
    just before each part and read just after: sweep_attack in exact mode
    over the dense main path's traffic at rates 64, 256 and 1024 (both
    systems, dense state; fc_full and the KitNET kernels must launch);
    run_peregrine (exact) and run_kitsune_baseline at rate 256; sweep_attack
    (rates 1 and 256) and run_peregrine (rate 64) at their defaults (switch
    mode) on smaller mirai traces; and the plain MD path against kitnet_score on one rate's records
    with the main path's net (within 1e-5)."""
    from repro_torch.core import compute_features, init_state
    from repro_torch.core.records import epoch_indices
    from repro_torch.detection import run_kitsune_baseline, run_peregrine
    from repro_torch.detection.md_backends import score_records
    from repro_torch.detection.metrics import auc
    from repro_torch.detection.sweep import sweep_attack
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.traffic import synth_trace, to_torch

    def part(fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    def check_sweep(res, rates, n_eval, where):
        for system in ("peregrine", "kitsune"):
            for rate in rates:
                m = res[system][rate]
                one_class = m["n_attack"] in (0, m["n_records"])   # AUC is NaN
                if m["n_records"] != len(epoch_indices(n_eval, rate)) or not (
                        one_class or 0.0 <= m["auc"] <= 1.0):
                    raise RuntimeError(f"eval {where}: {system} at {rate}: {m}")

    rec = {"phase": "eval"}
    rates = (64, 256, 1024)
    n_eval = len(data["eval"]["ts"])
    res, rec["sweep_exact_s"], launches = part(
        lambda: sweep_attack(data, rates, mode="exact"))
    check_sweep(res, rates, n_eval, "exact sweep")
    if min(launches[k] for k in ("fc_full", "kitnet_score", "kitnet_ae")) == 0:
        raise RuntimeError(f"eval exact sweep: a kernel of its path never launched: {launches}")
    rec["sweep_exact"] = res
    rec["sweep_exact_launches"] = launches

    (s, lab), rec["run_peregrine_exact_s"], launches = part(
        lambda: run_peregrine(data, 256, mode="exact"))
    if len(lab) != n_eval // 256 or not np.isfinite(s).all() or launches["fc_full"] == 0:
        raise RuntimeError("eval run_peregrine: wrong records, scores or launches")
    rec["run_peregrine_exact"] = {"auc": auc(s, lab), "records": int(len(lab)),
                                  "launches": launches}
    (s, lab), rec["run_kitsune_s"], launches = part(
        lambda: run_kitsune_baseline(data, 256))
    if len(lab) != len(epoch_indices(n_eval, 256, offset=len(data["train"]["ts"]))) \
            or not np.isfinite(s).all():
        raise RuntimeError("eval run_kitsune_baseline: wrong records or scores")
    rec["run_kitsune"] = {"auc": auc(s, lab), "records": int(len(lab)),
                          "launches": launches}

    small = synth_trace("mirai", n_train=4096, n_benign_eval=2048, n_attack=2048, seed=0)
    res, rec["sweep_switch_s"], launches = part(lambda: sweep_attack(small, (1, 256)))
    check_sweep(res, (1, 256), len(small["eval"]["ts"]), "switch sweep")
    rec["sweep_switch"] = res
    rec["sweep_switch_launches"] = launches
    # run_peregrine at its defaults on a quarter of that trace: the switch
    # oracle costs milliseconds a packet on the card
    quarter = synth_trace("mirai", n_train=1024, n_benign_eval=512, n_attack=512,
                          seed=0)
    (s, lab), rec["run_peregrine_switch_s"], launches = part(
        lambda: run_peregrine(quarter, 64))
    if len(lab) != len(quarter["eval"]["ts"]) // 64 or not np.isfinite(s).all():
        raise RuntimeError("eval run_peregrine (switch): wrong records or scores")
    rec["run_peregrine_switch"] = {"auc": auc(s, lab), "records": int(len(lab)),
                                   "launches": launches}

    _, f = compute_features(init_state(8192), to_torch(data["eval"], "cuda"))
    recs = f[torch.as_tensor(epoch_indices(n_eval, 256), device=f.device)]
    md_err = float(np.abs(score_records(net, recs, backend="einsum")
                          - score_records(net, recs, backend="cuda")).max())
    rec["md_plain_vs_kernel"] = {"records": int(recs.shape[0]), "max_abs_err": md_err}
    emit(rec, log)
    if not md_err <= MD_TOL:
        raise RuntimeError(f"eval: plain MD path vs kitnet_score: {md_err}")


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible, positions from 0."""
    q = np.arange(sq)[:, None]
    lo = q - window + 1 if window > 0 else np.zeros_like(q)
    hi = np.minimum(q, sk - 1) if causal else np.full_like(q, sk - 1)
    return int(np.clip(hi - np.maximum(lo, 0) + 1, 0, None).sum())


def flash_cost(B, H, K, Sq, Sk, D, causal, window, dtype) -> dict:
    """Bytes (q, k, v read once, the output written once) and operations
    (4*D a visible pair and head: two products of 2*D) of one call, and the
    bound against the rate of the arithmetic the kernel uses: split TF32 on
    the tensor cores (float32 inputs) or the bf16 tensor rate (bf16)."""
    esize = 4 if dtype == torch.float32 else 2
    byts = (2 * B * H * Sq * D + 2 * B * K * Sk * D) * esize
    ops = 4 * B * H * D * visible_pairs(Sq, Sk, causal, window)
    peak = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
    return {**bound(byts, ops, peak), "bytes": byts, "flops": ops,
            "peak": "tf32x3 tensor" if dtype == torch.float32 else "bf16 tensor"}


def flash_build_record(kern) -> dict:
    """Per instantiation of the flash kernel: ptxas's registers, stack and
    spills, the dynamic shared memory it launches with, and its tensor-core
    (HGMMA: wgmma, HMMA: mma.sync) and FFMA instruction counts."""
    import ctypes
    import re
    smem_of = ctypes.CDLL(str(kern.lib_path())).flash_attention_smem
    smem_of.argtypes, smem_of.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int

    def key(mangled):
        m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
        return (("float32" if m.group(1) == "f" else "bfloat16"), int(m.group(2))) if m else None

    out, cur = {}, None
    for line in kern.build_log.splitlines():
        if "Compiling entry function" in line:
            cur = key(line)
            if cur:
                out[cur] = {"smem_bytes": smem_of(cur[1], int(cur[0] == "bfloat16"))}
        elif cur and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    for mangled, counts in sass_counts(kern.lib_path()).items():
        if key(mangled) in out:
            out[key(mangled)]["sass"] = counts
    return {f"{dt}_D{d}": rec for (dt, d), rec in sorted(out.items())}


def phase_flash(dev, log) -> dict:
    """The flash-attention kernel against its plain version on the card, at
    the JAX package's test shapes and at gemma2-2b's prefill shape; times
    of the kernel, its plain version and SDPA at that shape."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    rng = np.random.default_rng(5)

    def inputs(B, H, K, Sq, Sk, D, dtype):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
                for s in ((B, H, Sq, D), (B, K, Sk, D), (B, K, Sk, D))]

    def check(qkv, tol, what, rtol=0.0, **kw):
        """Max abs error, and the largest share of the bound used; fails
        unless |got - want| <= tol + rtol * |want| everywhere."""
        got = flash_attention(*qkv, **kw)
        want = flash_attention_ref(*qkv, **kw)
        torch.cuda.synchronize()
        if got.dtype != qkv[0].dtype or not torch.isfinite(got).all():
            raise RuntimeError(f"flash {what}: wrong dtype or not finite")
        got, want = got.float(), want.float()
        err = max_abs(got, want)
        used = float(((got - want).abs() / (tol + rtol * want.abs())).max())
        if not used <= 1.0:
            raise RuntimeError(f"flash {what}: |got - want| exceeds {tol} + "
                               f"{rtol} * |want| ({used} of it; max abs err {err})")
        return {"max_abs_err": err, "share_of_tol": used}

    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for shape in ((1, 4, 4, 64, 64, 32), (2, 4, 2, 64, 64, 64),
                      (1, 8, 1, 96, 96, 32), (2, 4, 4, 1, 128, 32),
                      (1, 2, 2, 200, 72, 64)):
            cases[f"{name}_{shape}"] = check(inputs(*shape, dt), FLASH_TOL[name],
                                             f"{name} {shape}",
                                             causal=shape[3] == shape[4])
    for window, cap in ((16, 0.0), (0, 30.0), (24, 50.0)):
        cases[f"float32_window{window}_softcap{cap}"] = check(
            inputs(1, 4, 2, 80, 80, 32, torch.float32), FLASH_TOL["float32"],
            f"window {window} softcap {cap}", causal=True, window=window,
            softcap=cap)
    shape = (1, 8, 4, 8192, 8192, 256)
    model = {}
    for dt, tol, rtol in ((torch.float32, FLASH_MODEL_TOL, 0.0),
                          (torch.bfloat16, FLASH_MODEL_BF16_ATOL, FLASH_MODEL_BF16_RTOL)):
        qkv = inputs(*shape, dt)
        name = str(dt).split(".")[1]
        for window in (4096, 0):
            kw = dict(causal=True, window=window, softcap=50.0)
            rec = {**check(qkv, tol, f"{name} S=8192 window {window}", rtol, **kw),
                   "tol": f"{tol} + {rtol} * |want|",
                   **timed(lambda: flash_attention(*qkv, **kw), 10,
                           "flash_attention_kernel"),
                   "plain_ms": cuda_ms(lambda: flash_attention_ref(*qkv, **kw), 3),
                   **flash_cost(*shape, True, window, dt)}
            model[f"{name}_window{window}"] = rec
        q, k, v = qkv
        model[f"{name}_sdpa_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10)
        # the same call on kv heads repeated to H beforehand (not timed)
        k8, v8 = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
        model[f"{name}_sdpa_repeated_kv_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k8, v8, is_causal=True), 10)
        del qkv, q, k, v, k8, v8
    row = model["float32_window0"]
    library = {}
    for name in ("float32", "bfloat16"):
        calls = {"scaled_dot_product_attention(enable_gqa=True)": model[f"{name}_sdpa_ms"],
                 "scaled_dot_product_attention, kv heads repeated to H beforehand":
                 model[f"{name}_sdpa_repeated_kv_ms"]}
        library[name] = min(calls.items(), key=lambda kv: kv[1])
    b16 = model["bfloat16_window0"]
    emit({"phase": "flash", "test_shapes_max_abs_err": cases, "model_shape": model}, log)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            "max_abs_err": max([r["max_abs_err"] for c, r in cases.items()
                                if c.startswith("float32")]
                               + [r["max_abs_err"] for c, r in model.items()
                                  if c.startswith("float32_window")]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": library["float32"][1],
            "bf16": {"ms": b16["ms"], "plain_ms": b16["plain_ms"],
                     "bound_ms": b16["bound_ms"], "bound_by": b16["bound_by"],
                     "library_ms": library["bfloat16"][1],
                     "library": library["bfloat16"][0]},
            "shape": {"B": 1, "H": 8, "K": 4, "S": 8192, "D": 256,
                      "dtype": "float32", "causal": True, "window": 0,
                      "softcap": 50.0, "peak": row["peak"],
                      "library": library["float32"][0] + ", causal, no softcap"}}


def lm_args(**kw):
    """The launcher's arguments for full-width gemma2-2b on the card."""
    import argparse
    base = dict(arch="gemma2-2b", reduced=False, device="cuda", seed=0,
                slots=4, requests=8, prompt_len=16, max_new=16, max_seq=256)
    return argparse.Namespace(**{**base, **kw})


def phase_lm_main(log) -> Tuple[int, float]:
    """LM serving of full-width gemma2-2b through launch.serve.serve_lm, for
    the JAX launcher's traffic and for 8192-token prompts; each with the
    launch counts zeroed just before and read just after.  Returns the flash
    launches of both and the long-prompt run's wall seconds."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import serve_lm

    cfg = get_arch("gemma2-2b")
    launches = 0
    for name, args in (("launcher", lm_args()),
                       ("long_prompt", lm_args(requests=4, prompt_len=8192,
                                               max_seq=8192 + 16))):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        rec = serve_lm(args)
        n_flash = rec["launches"]["flash_attention"]
        if n_flash == 0 or n_flash != cfg.n_layers * rec["prefills"]:
            raise RuntimeError(f"lm {name}: {n_flash} flash launches for "
                               f"{rec['prefills']} prefills of {cfg.n_layers} layers")
        outs = rec.pop("outputs")
        if (len(outs) != args.requests
                or any(len(v) != args.max_new or min(v) < 0 or max(v) >= cfg.vocab
                       for v in outs.values())):
            raise RuntimeError(f"lm {name}: outputs misshapen or out of the vocabulary")
        launches += n_flash
        emit({"phase": "lm_main", "traffic": name, **rec,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "first_output": outs[0]}, log)
    return launches, rec["wall_s"]


def traced_window(fn) -> dict:
    """``fn`` once under torch.profiler: wall seconds, the device's busy
    seconds (events that ran on the card, each counted once) and their
    count, the matrix products' share of them, the flash kernel's device
    time, and the top device and host ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    events = device_events(prof, averages)
    busy_us = sum(us for us, _ in events.values())
    flash = [(us, n) for key, (us, n) in events.items() if "flash_attention_kernel" in key]
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:10]
    return {"traced_s": wall, "device_busy_s": busy_us * 1e-6,
            "busy_share_traced": busy_us * 1e-6 / wall,
            "device_events": sum(n for _, n in events.values()),
            "gemm_share": sum(us for key, (us, _) in events.items()
                              if any(w in key.lower() for w in GEMM_NAMES)) / max(busy_us, 1),
            "flash_launches": sum(n for _, n in flash),
            "flash_device_s": sum(u for u, _ in flash) * 1e-6,
            "top_device": {key: {"ms": us * 1e-3, "count": n, "share": us / busy_us}
                           for key, (us, n) in top},
            "top_host_self_ms": dict(sorted(
                ((e.key, e.self_cpu_time_total * 1e-3) for e in averages),
                key=lambda kv: -kv[1])[:10])}


def phase_lm_trace(untraced_s: float, log) -> None:
    """The long-prompt traffic again under torch.profiler, in two windows:
    the engine's first tick (the four 8192-token prefills and one decode
    step), then the rest of the run (14 decode steps).  The device's busy
    share over the whole run, against the traced wall and the untraced one
    of phase lm_main, and for each window the top device and host ops."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.lm_engine import Request, ServeEngine

    args = lm_args(requests=4, prompt_len=8192, max_seq=8192 + 16)
    model = build_model(get_arch("gemma2-2b"), device="cuda")
    eng = ServeEngine(model, model.init_params(0), batch_slots=4,
                      max_seq=args.max_seq, device="cuda")
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        eng.submit(Request(rid, torch.from_numpy(rng.integers(1, model.cfg.vocab, 8192)),
                           max_new=args.max_new))
    torch.cuda.synchronize()
    first = traced_window(eng.step)
    rest = traced_window(eng.run)
    busy = first["device_busy_s"] + rest["device_busy_s"]
    traced = first["traced_s"] + rest["traced_s"]
    flash_s = first["flash_device_s"] + rest["flash_device_s"]
    flash_n = first["flash_launches"] + rest["flash_launches"]
    emit({"phase": "lm_trace", "traced_s": traced, "device_busy_s": busy,
          "busy_share_traced": busy / traced, "busy_share_untraced": busy / untraced_s,
          "prefill_s": eng.stats["prefill_s"], "decode_s": eng.stats["decode_s"],
          "decode_steps": eng.stats["decode_steps"],
          "flash_device_ms_per_launch": flash_s / flash_n * 1e3 if flash_n else None,
          "flash_share_of_busy": flash_s / busy,
          "prefills_window": first, "decode_window": rest}, log)


# the families beyond dense at full width, each model's depth cut where its
# float32 weights would not fit beside the rest (None: uncut)
LM_FAMILIES = (("phi3.5-moe-42b-a6.6b", 4), ("zamba2-2.7b", None),
               ("xlstm-125m", None), ("qwen2-vl-72b", 4), ("hubert-xlarge", None))
FAMILY_PREFILL, FAMILY_DECODE, HUBERT_FRAMES = 2048, 16, 1500
# xlstm-125m at full width with random weights amplifies rounding through
# its 12 blocks (the mLSTM's normaliser max(|q.n|, exp(-m)) divides by small
# dot products).  On the CPU (python tests/test_torch_recurrent.py
# --full-width): a one-ulp nudge of the embeddings moves its logits by up to
# 1.3e-2 at 2048 tokens, the port and the JAX package with the same weights
# differ by up to 1.8e-2, and the JAX package's own prefill + 16 decode
# steps (the recurrent form) differ from its full forward (the chunked form)
# by up to 2.5e-3 (the port's by 1.0e-3); a fault in the decode state moves
# them by 4.0-7.3 (a zeroed C, a block's state reset, a skipped token).  Its
# prefill's rows and decode steps against the full forward are held to
# 5e-2; the phase measures the one-ulp floor on the card beside them.
XLSTM_REF_TOL = 5e-2
# the flash kernel at the shapes these families give it: (B, H, K, S, D, causal)
FAMILY_FLASH_SHAPES = {"zamba2": (1, 32, 32, 2048, 80, True),
                       "hubert": (1, 16, 16, 1500, 80, False)}


def flash_per_prefill(cfg) -> int:
    """Flash launches a prefill: one an attention application."""
    from repro_torch.models.transformer import n_attn_apps
    return {"hybrid": n_attn_apps(cfg), "ssm": 0}.get(cfg.family, cfg.n_layers)


def sync_time(fn, dev):
    """(fn(), its wall seconds), the card synchronised before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def family_engine(model, params, dev) -> dict:
    """The JAX launcher's traffic (lm_args: 4 slots, 8 requests of 16-token
    prompts from default_rng(0), max_new 16, max_seq 256, bf16 cache)
    through ServeEngine, launch counts zeroed just before and read just
    after; a MoE model's dropped token slots in each prefill and over the
    decode steps."""
    import dataclasses
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe
    from repro_torch.models.lm_engine import Request, ServeEngine

    args = lm_args()
    cfg = model.cfg
    drops = {"prefills": [], "decode": []}

    def counting(fn, where):
        def wrapped(*a, **kw):
            with moe.count_drops() as d:
                out = fn(*a, **kw)
            drops[where].append(int(sum(d)) if d else 0)
            return out
        return wrapped

    eng = ServeEngine(model, params, batch_slots=args.slots, max_seq=args.max_seq,
                      device=dev)
    if cfg.is_moe:
        eng.model = dataclasses.replace(model, forward=counting(model.forward, "prefills"),
                                        decode_step=counting(model.decode_step, "decode"))
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(Request(rid, torch.from_numpy(rng.integers(1, cfg.vocab, args.prompt_len)),
                           max_new=args.max_new))
    reset_launch_counts()
    outs, wall = sync_time(eng.run, dev)
    n_flash = launch_counts()["flash_attention"]
    st = eng.stats
    if n_flash != flash_per_prefill(cfg) * st["prefills"]:
        raise RuntimeError(f"lm_families {cfg.name}: {n_flash} flash launches for "
                           f"{st['prefills']} prefills")
    if (len(outs) != args.requests
            or any(len(v) != args.max_new or min(v) < 0 or max(v) >= cfg.vocab
                   for v in outs.values())):
        raise RuntimeError(f"lm_families {cfg.name}: outputs misshapen or out of "
                           "the vocabulary")
    rec = {"wall_s": wall, **st, "flash_launches": n_flash,
           "prefill_s_per_request": st["prefill_s"] / st["prefills"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "first_output": outs[0]}
    if cfg.is_moe:
        rec["moe_dropped_slots"] = {"each_prefill": drops["prefills"],
                                    "decode_steps_total": sum(drops["decode"]),
                                    "decode_steps": len(drops["decode"])}
    return rec


def route_reference(model, params, dev, S: int, n_dec: int = 16) -> Tuple[dict, int, list]:
    """One S-token prefill of a decoder with the same weights through the
    default route (on the card, the flash kernel) and through the plain
    route (the JAX package's routing), then ``n_dec`` decode steps fed the
    same tokens: logits within LM_REF_TOL, greedy tokens equal where the
    top-2 margin exceeds it.  Returns the record, the flash launches of the
    default route's prefill and the checks that failed."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe

    cfg = model.cfg
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (1, S))).to(dev)
    sample = torch.from_numpy(np.sort(rng.choice(S - 1, 64, replace=False))).to(dev)
    out, n_flash = {}, 0
    for route in (None, "plain"):
        reset_launch_counts()
        with moe.count_drops() as d:
            (logits, _, cache), t = sync_time(lambda: model.forward(
                params, {"tokens": toks}, build_cache=True, max_seq=S + n_dec,
                attn_impl=route), dev)
        if route is None:
            n_flash = launch_counts()["flash_attention"]
        out[route] = {"last": logits[0, -1].clone(), "sample": logits[0, sample].clone(),
                      "cache": cache, "prefill_s": t, "dropped": [int(x) for x in d]}
        del logits
    teacher = [int(out[None]["last"].argmax())]
    steps = {None: [], "plain": []}
    t_dec = []
    for _ in range(n_dec):
        tok = torch.tensor([[teacher[-1]]], device=dev)
        for route in (None, "plain"):
            (lg, out[route]["cache"]), dt = sync_time(lambda: model.decode_step(
                params, tok, out[route]["cache"]), dev)
            steps[route].append(lg[0, 0])
            if route is None:
                t_dec.append(dt)
        teacher.append(int(steps[None][-1].argmax()))
    k_rows = torch.stack([out[None]["last"]] + steps[None])
    p_rows = torch.stack([out["plain"]["last"]] + steps["plain"])
    errs = {"last": max_abs(out[None]["last"], out["plain"]["last"]),
            "sample64": max_abs(out[None]["sample"], out["plain"]["sample"]),
            f"decode{n_dec}": max_abs(k_rows[1:], p_rows[1:])}
    top2 = p_rows.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LM_REF_TOL
    same = k_rows.argmax(-1) == p_rows.argmax(-1)
    finite = all(bool(torch.isfinite(t).all()) for t in (k_rows, p_rows, out[None]["sample"]))
    rec = {"tokens": S, "decode_steps": n_dec, "tol": LM_REF_TOL, "max_abs_err": errs,
           "logit_absmax": float(k_rows.abs().max()), "greedy_equal": int(same.sum()),
           "rows": int(same.numel()), "decided_rows": int(decided.sum()),
           "prefill_s": {"kernel": out[None]["prefill_s"],
                         "plain": out["plain"]["prefill_s"]},
           "decode_ms_per_step": 1e3 * float(np.median(t_dec))}
    if cfg.is_moe:
        rec["moe_dropped_slots"] = {"kernel": out[None]["dropped"],
                                    "plain": out["plain"]["dropped"]}
    failed = []
    if not finite or max(errs.values()) > LM_REF_TOL:
        failed.append(f"kernel vs plain route logits differ: {errs}")
    if not bool(same[decided].all()):
        failed.append("greedy tokens differ where the top-2 margin exceeds the tolerance")
    return rec, n_flash, failed


def xlstm_reference(model, params, dev) -> Tuple[dict, int, list]:
    """xlstm-125m, which has no attention: a prefill of FAMILY_PREFILL
    tokens and FAMILY_DECODE decode steps of the next tokens against one
    full forward over them all (XLSTM_REF_TOL), beside the rounding floor
    (the full forward with the embeddings one ulp off)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    S, n_dec = FAMILY_PREFILL, FAMILY_DECODE
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, model.cfg.vocab, (1, S + n_dec))).to(dev)
    reset_launch_counts()
    (full, _, _), t_full = sync_time(lambda: model.forward(params, {"tokens": toks}), dev)
    (pre, _, cache), t_pre = sync_time(lambda: model.forward(
        params, {"tokens": toks[:, :S]}, build_cache=True), dev)
    rows, t_dec = [pre[0, -1]], []
    for i in range(n_dec):
        (lg, cache), dt = sync_time(lambda: model.decode_step(
            params, toks[:, S + i:S + i + 1], cache), dev)
        rows.append(lg[0, 0])
        t_dec.append(dt)
    n_flash = launch_counts()["flash_attention"]
    got, want = torch.stack(rows), full[0, S - 1:]
    per_step = (got.double() - want.double()).abs().amax(-1)
    errs = {"prefill_rows_vs_full": max_abs(pre[0], full[0, :S]),
            "decode_vs_full": float(per_step.max())}
    emb = params.embed.detach().clone()
    sign = torch.randint(0, 2, emb.shape, generator=torch.Generator(dev).manual_seed(2),
                         device=dev) * 2.0 - 1.0
    with torch.no_grad():
        params.embed.mul_(1 + sign * 2.0 ** -23)
        nudged, _, _ = model.forward(params, {"tokens": toks})
        params.embed.copy_(emb)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(full).all())
    rec = {"tokens": S, "decode_steps": n_dec, "tol": XLSTM_REF_TOL,
           "max_abs_err": errs, "decode_err_per_step": per_step.tolist(),
           "ulp_nudge_floor": max_abs(nudged, full),
           "logit_absmax": float(want.abs().max()), "finite": finite,
           "full_forward_s": t_full, "prefill_s": t_pre,
           "decode_ms_per_step": 1e3 * float(np.median(t_dec))}
    failed = []
    if not finite or max(errs.values()) > XLSTM_REF_TOL:
        failed.append(f"prefill + decode vs full forward {errs}")
    return rec, n_flash, failed


def encoder_reference(model, params, dev) -> Tuple[dict, int, list]:
    """hubert-xlarge: one forward over HUBERT_FRAMES frames of embeddings
    through the kernel and through the plain route (LM_REF_TOL); its
    decode step raises."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(1)
    emb = torch.from_numpy(rng.standard_normal((1, HUBERT_FRAMES, model.cfg.d_in))
                           .astype(np.float32)).to(dev)
    reset_launch_counts()
    (lk, _, _), t_k = sync_time(lambda: model.forward(params, {"embeds": emb}), dev)
    n_flash = launch_counts()["flash_attention"]
    (lp, _, _), t_p = sync_time(lambda: model.forward(params, {"embeds": emb},
                                                      attn_impl="plain"), dev)
    err = max_abs(lk, lp)
    finite = bool(torch.isfinite(lk).all())
    rec = {"frames": HUBERT_FRAMES, "tol": LM_REF_TOL, "max_abs_err": {"all_rows": err},
           "logit_absmax": float(lk.abs().max()), "finite": finite,
           "forward_s": {"kernel": t_k, "plain": t_p}}
    failed = [] if finite and err <= LM_REF_TOL else [f"kernel vs plain route {err}"]
    try:
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.long, device=dev), {})
        failed.append("the encoder has a decode step")
    except ValueError:
        pass
    return rec, n_flash, failed


def family_reference(model, params, dev) -> Tuple[dict, int, list]:
    cfg = model.cfg
    if cfg.is_encoder:
        return encoder_reference(model, params, dev)
    if cfg.family == "ssm":
        return xlstm_reference(model, params, dev)
    return route_reference(model, params, dev, FAMILY_PREFILL, FAMILY_DECODE)


def phase_lm_reference(log) -> None:
    """One 8192-token prefill of full-width gemma2-2b with the same weights
    through the kernel and through the plain route (blockwise attention, as
    the JAX package routes it), then 16 decode steps fed the same tokens
    (route_reference)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    model = build_model(get_arch("gemma2-2b"), device="cuda")
    rec, _, failed = route_reference(model, model.init_params(0), torch.device("cuda"),
                                     8192)
    emit({"phase": "lm_reference", **rec}, log)
    if failed:
        raise RuntimeError(f"lm_reference: {'; '.join(failed)}")


def family_flash_shapes() -> dict:
    """The flash kernel at the shapes zamba2 and hubert give it (float32, as
    their prefills run): against its plain version (FLASH_MODEL_TOL), its
    time, the plain version's, scaled_dot_product_attention's on the same
    inputs, and the bound at the true head dim (the kernel pads 80 to
    128)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    rng = np.random.default_rng(11)
    out = {}
    for name, (B, H, K, S, D, causal) in FAMILY_FLASH_SHAPES.items():
        q, k, v = (torch.from_numpy(rng.standard_normal((B, n, S, D)).astype(np.float32))
                   .cuda() for n in (H, K, K))
        got = flash_attention(q, k, v, causal=causal)
        err = max_abs(got, flash_attention_ref(q, k, v, causal=causal))
        if not err <= FLASH_MODEL_TOL:
            raise RuntimeError(f"flash at {name}'s shape: max abs err {err}")
        out[name] = {"shape": {"B": B, "H": H, "K": K, "S": S, "D": D, "causal": causal,
                               "dtype": "float32"},
                     "max_abs_err": err,
                     **timed(lambda: flash_attention(q, k, v, causal=causal), 20,
                             "flash_attention_kernel"),
                     "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal), 5),
                     "library_ms": cuda_ms(
                         lambda: torch.nn.functional.scaled_dot_product_attention(
                             q, k, v, is_causal=causal), 20),
                     **flash_cost(B, H, K, S, S, D, causal, 0, torch.float32)}
        del q, k, v, got
    return out


def phase_lm_families(log) -> Tuple[int, dict]:
    """Each family beyond dense on the card at full width (float32
    parameters from seed 0, bf16 cache; depth cut as LM_FAMILIES says, by
    dataclasses.replace): a decoder serves the launcher's traffic through
    ServeEngine (family_engine), then family_reference; the encoder runs
    family_reference alone.  Flash launches equal attention applications x
    prefills.  Each model is freed before the next is built.  Returns the
    flash launches of the families' runs and the flash kernel's record at
    their shapes."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = 0
    for arch, depth in LM_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full = get_arch(arch)
        cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
        model = build_model(cfg, device=dev)
        params = model.init_params(0)
        torch.cuda.synchronize()
        rec = {"phase": "lm_families", "arch": arch, "family": cfg.family,
               "cut": None if depth is None else {"n_layers": [full.n_layers, depth]},
               "params": cfg.param_count(),
               "param_gib": sum(p.numel() * p.element_size()
                                for p in params.parameters()) / 2 ** 30,
               "init_s": time.perf_counter() - t0,
               "flash_per_prefill": flash_per_prefill(cfg)}
        if not cfg.is_encoder:
            rec["engine"] = family_engine(model, params, dev)
            launches += rec["engine"]["flash_launches"]
        rec["reference"], n_flash, failed = family_reference(model, params, dev)
        launches += n_flash
        if n_flash != flash_per_prefill(cfg):
            failed.append(f"{n_flash} flash launches for one prefill")
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["seconds"] = time.perf_counter() - t0
        emit(rec, log)
        if failed:
            raise RuntimeError(f"lm_families {arch}: {'; '.join(failed)}")
        del model, params
    gc.collect()
    torch.cuda.empty_cache()
    shapes = family_flash_shapes()
    emit({"phase": "lm_families", "flash_at_family_shapes": shapes,
          "flash_launches": launches, "seconds": time.perf_counter() - t_phase}, log)
    return launches, shapes


# tests/test_torch_training.py's envelope: loss and grad norm within 1e-5
# relative; parameters within 1e-5 + 1e-5 |p| but for a share of them (an
# AdamW update divides g by |g| + eps; int8: a gradient at a rounding
# boundary quantises a step apart), which stay within 2 * sum(lr)
TRAIN_F32_TOL = 1e-5
TRAIN_F32_SHARE = 1e-4
TRAIN_EF_GN_TOL = 1e-4
TRAIN_EF_SHARE = 1e-3


def train_batches(vocab: int, batch: int, seq: int, n: int, seed: int, dev) -> list:
    from repro_torch.data import Prefetcher, lm_batches
    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in Prefetcher(lm_batches(vocab, batch, seq, n, seed=seed))]


def family_batches(cfg, batch: int, seq: int, n: int, seed: int, dev) -> list:
    """train_batches, or for a model that takes embeddings (hubert) seeded
    normal numpy ``embeds`` (batch, seq, d_in) labelled as HuBERT's targets
    are, by cluster: each frame's nearest of ``vocab`` seeded random
    centroids by inner product (labels in [0, vocab))."""
    if cfg.embed_inputs:
        return train_batches(cfg.vocab, batch, seq, n, seed, dev)
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((cfg.d_in, cfg.vocab)).astype(np.float32)
    out = []
    for _ in range(n):
        e = rng.standard_normal((batch, seq, cfg.d_in)).astype(np.float32)
        out.append({"embeds": torch.from_numpy(e).to(dev),
                    "labels": torch.from_numpy((e @ centroids).argmax(-1)).to(dev)})
    return out


def phase_train_main(log) -> None:
    """Full-width gemma2-2b training on the card: float32 parameters from
    seed 0, bf16 compute, AdamW, the JAX launcher's batch 8 x seq 128 from
    lm_batches(seed=0) and warmup, 10 steps of training.make_train_step,
    launch counts zeroed before step 1 and read after step 10 (the training
    path runs none of the port's kernels).  After step 1 every parameter
    (each layer's slice of a stacked leaf) has a finite, nonzero gradient;
    every loss is finite; the mean of the last 3 is below the first.
    Seconds a step (median of steps 3-10), tokens/s and the model-FLOPs
    share from these untraced steps; then the same 10 steps again from the
    same state with steps 3-9 and step 10 under torch.profiler (two
    windows): the device's busy share over steps 3-10, against the traced
    wall and the untraced one, and step 10's top device and host ops."""
    import gc
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("gemma2-2b")
    n_steps, B, S = 10, 8, 128
    model = build_model(cfg, device="cuda")
    tc = TrainConfig(warmup_steps=max(n_steps // 10, 1))
    step = make_train_step(model, tc)
    batches = train_batches(cfg.vocab, B, S, n_steps, tc.seed, "cuda")
    t0 = time.perf_counter()
    state = init_train_state(model, tc, tc.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    times, mets = [], []

    def one(b):
        nonlocal state
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in met.items()})

    reset_launch_counts()
    one(batches[0])
    _, _, grads = step.compute_grads(state["params"], batches[1])
    bad, grad_leaves = bad_grad_leaves(grads)
    del grads
    for b in batches[1:]:
        one(b)
    launches = launch_counts()
    losses = [m["loss"] for m in mets]
    untraced_all = list(times)
    untraced = times[2:]
    step_s = float(np.median(untraced))
    flops = 6 * cfg.param_count() * B * S
    peak = torch.cuda.max_memory_allocated()

    # the same steps again, steps 3-10 traced
    state = None
    gc.collect()
    state = init_train_state(model, tc, tc.seed)
    times.clear()
    one(batches[0])
    one(batches[1])
    win = traced_window(lambda: [one(b) for b in batches[2:9]])
    last = traced_window(lambda: one(batches[9]))
    busy = win["device_busy_s"] + last["device_busy_s"]
    wall = win["traced_s"] + last["traced_s"]
    emit({"phase": "train_main", "arch": cfg.name, "params": cfg.param_count(),
          "batch": B, "seq": S, "steps": n_steps, "optimizer": tc.optimizer,
          "compute_dtype": tc.compute_dtype, "init_s": init_s, "losses": losses,
          "grad_norms": [m["grad_norm"] for m in mets[:n_steps]],
          "lrs": [m["lr"] for m in mets[:n_steps]],
          "step_s": untraced_all,
          "step_s_median_3_10": step_s, "tokens_per_s": B * S / step_s,
          "flops_per_step": flops, "mfu_bf16": flops / step_s / BF16_FLOPS,
          "peak_mem_gib": peak / 2 ** 30, "grad_leaves_checked": grad_leaves,
          "launches": launches, "traced_step_s": times[2:],
          "device_busy_s_steps_3_10": busy, "busy_share_traced": busy / wall,
          "device_events_step10": last["device_events"],
          "gemm_share_step10": last["gemm_share"],
          "busy_share_untraced": busy / sum(untraced),
          "rerun_losses_equal": [m["loss"] for m in mets[n_steps:]] == losses,
          "top_device_step10": last["top_device"],
          "top_host_self_ms_step10": last["top_host_self_ms"]}, log)
    if bad:
        raise RuntimeError(f"train_main: zero or non-finite gradients after step 1: {bad}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"train_main: non-finite losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise RuntimeError(f"train_main: the loss did not fall: {losses}")
    if any(launches.values()):
        raise RuntimeError(f"train_main: the training path launched kernels {launches}")
    del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()


def compare_train(tc, n: int = 3, arch: str = "gemma2-2b") -> dict:
    """reduced(arch) trained ``n`` steps on the card and on the CPU from the
    same state and batches (family_batches); the worst errors against the
    CPU (grad norm from step 2 on apart: the xLSTM carries the AdamW-eps
    differences of step 1 into it)."""
    from repro_torch import tree
    from repro_torch.configs import get_arch, reduced
    from repro_torch.interop import train_state_from_arrays, train_state_to_arrays
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state, make_train_step

    cfg = reduced(get_arch(arch))
    models = {d: build_model(cfg, device=d) for d in ("cpu", "cuda")}
    arrays = train_state_to_arrays(init_train_state(models["cpu"], tc, 0))
    states = {d: train_state_from_arrays(cfg, tc, arrays, device=d) for d in models}
    steps = {d: make_train_step(m, tc) for d, m in models.items()}
    batches = {d: family_batches(cfg, 8, 32, n, 1, d) for d in models}
    errs = {"loss_rel": 0.0, "aux_abs": 0.0, "grad_norm_rel": 0.0,
            "grad_norm_rel_later": 0.0, "params_max_abs": 0.0, "share_past_tol": 0.0}
    lrs = []
    for i in range(n):
        mets = {}
        for d in models:
            states[d], met = steps[d](states[d], batches[d][i])
            mets[d] = {k: float(v) for k, v in met.items()}
        lrs.append(mets["cpu"]["lr"])
        for key in ("loss", "grad_norm"):
            name = key + ("_rel_later" if key == "grad_norm" and i else "_rel")
            errs[name] = max(errs[name], abs(mets["cuda"][key] - mets["cpu"][key])
                             / abs(mets["cpu"][key]))
        errs["aux_abs"] = max(errs["aux_abs"], abs(mets["cuda"]["aux"] - mets["cpu"]["aux"]))
        got = torch.cat([t.cpu().flatten() for t in tree.leaves(states["cuda"]["params"])])
        want = torch.cat([t.flatten() for t in tree.leaves(states["cpu"]["params"])])
        d = (got - want).abs()
        errs["params_max_abs"] = max(errs["params_max_abs"], float(d.max()))
        errs["share_past_tol"] = max(errs["share_past_tol"], float(
            (d > TRAIN_F32_TOL + TRAIN_F32_TOL * want.abs()).float().mean()))
    errs["two_sum_lr"] = 2 * sum(lrs)
    errs["final_loss"] = {d: mets[d]["loss"] for d in mets}
    return errs


def phase_train_reference(log) -> None:
    """compare_train in float32 compute (TF32 off) for the plain step, remat
    "dots" and int8 error feedback, each within the CPU tests' envelope."""
    from repro_torch.configs import TrainConfig

    t0 = time.perf_counter()
    out = {}
    for name, kw in (("f32", {}), ("remat_dots", {"remat": "dots"}),
                     ("int8_ef", {"grad_compression": "int8_ef"})):
        tc = TrainConfig(compute_dtype="float32", learning_rate=1e-3, warmup_steps=2, **kw)
        out[name] = compare_train(tc)
    emit({"phase": "train_reference", "tol": TRAIN_F32_TOL, "errs": out,
          "seconds": time.perf_counter() - t0}, log)
    for name, e in out.items():
        ef = name == "int8_ef"
        gn = TRAIN_EF_GN_TOL if ef else TRAIN_F32_TOL
        ok = (e["loss_rel"] <= TRAIN_F32_TOL
              and max(e["grad_norm_rel"], e["grad_norm_rel_later"]) <= gn
              and e["params_max_abs"] <= e["two_sum_lr"]
              and e["share_past_tol"] <= (TRAIN_EF_SHARE if ef else TRAIN_F32_SHARE))
        if not ok:
            raise RuntimeError(f"train_reference {name}: card vs CPU outside the envelope: {e}")


def phase_train_resume(log) -> None:
    """launch.train.train_lm end to end at --reduced (10 steps, a checkpoint
    every 2); then resilient_loop with failures injected at steps 3, 7, 7
    and a checkpoint every 2 over 12 batches against an uninterrupted run
    (rtol 1e-5, atol 1e-6, tests/test_fault_tolerance.py); then its last
    checkpoint, written on the card, restored into a CPU state equal to the
    card's.  Checkpoints under chiprun_out/train_ckpt, removed after."""
    import shutil
    from repro_torch import tree
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.launch.train import parser, train_lm
    from repro_torch.models import build_model
    from repro_torch.training import CheckpointManager, init_train_state, make_train_step
    from repro_torch.training.fault import FailureInjector, resilient_loop

    root = ROOT / "chiprun_out" / "train_ckpt"
    t0 = time.perf_counter()
    try:
        rec = train_lm(parser().parse_args(
            ["--arch", "gemma2-2b", "--reduced", "--steps", "10", "--ckpt-every", "2",
             "--ckpt-dir", str(root / "launcher"), "--device", "cuda"]))
        launcher_s = time.perf_counter() - t0
        if (rec["steps"] != 10 or rec["restarts"] or not np.isfinite(rec["loss"])
                or rec["ckpt_steps"] != [6, 8, 10]):
            raise RuntimeError(f"train_resume: launcher run {rec}")
        cfg = reduced(get_arch("gemma2-2b"))
        model = build_model(cfg, device="cuda")
        tc = TrainConfig(learning_rate=1e-3)
        step = make_train_step(model, tc)
        batches = train_batches(cfg.vocab, 4, 16, 12, 4, "cuda")
        ref = init_train_state(model, tc, 0)
        for b in batches:
            ref, _ = step(ref, b)
        ckpt = CheckpointManager(str(root / "fault"), keep=3)
        out = resilient_loop(step, init_train_state(model, tc, 0), batches, ckpt,
                             ckpt_every=2, injector=FailureInjector(fail_at=[3, 7, 7]),
                             max_restarts=5)
        err = max(max_abs(a, b) for a, b in zip(tree.leaves(out["state"]["params"]),
                                                 tree.leaves(ref["params"])))
        for a, b in zip(tree.leaves(out["state"]["params"]), tree.leaves(ref["params"])):
            assert_close(a, b, "train_resume: resumed vs uninterrupted", rtol=1e-5, atol=1e-6)
        cpu_target = init_train_state(build_model(cfg, device="cpu"), tc, 1)
        restored, rstep = ckpt.restore(cpu_target)
        same = all(a.device.type == "cpu" and torch.equal(a, b.cpu())
                   for a, b in zip(tree.leaves(restored), tree.leaves(out["state"])))
        emit({"phase": "train_resume", "launcher": rec, "launcher_s": launcher_s,
              "restarts": out["restarts"], "completed": out["completed"],
              "resumed_vs_uninterrupted_max_abs": err, "restored_step": rstep,
              "card_checkpoint_on_cpu_equal": same,
              "seconds": time.perf_counter() - t0}, log)
        if out["restarts"] < 2 or out["completed"] != len(batches):
            raise RuntimeError(f"train_resume: {out['restarts']} restarts, "
                               f"{out['completed']} steps")
        if rstep != len(batches) or not same:
            raise RuntimeError("train_resume: the card's checkpoint restored on the "
                               "CPU differs from the card's state")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the families trained at full width on one card: (arch, layers kept or None
# for the whole depth, optimizer).  The depth cuts follow from about 18 B a
# parameter under AdamW (float32 parameter, gradient, m and v, and the bf16
# copy) and 10 under Adafactor, before activations (PERF.md section 4):
# phi3.5-moe 2 of 32 layers (1.30 B a layer + 0.26 B of embedding and head,
# ~48 GiB); qwen2-vl 2 of 80 (0.88 B a layer + 2.49 B of untied embedding
# and head, ~40 GiB under Adafactor; AdamW would hold ~57 GiB for one
# layer).  kimi-k2 has no full-width cut that fits (one layer is 16.9 B
# parameters, 63 GiB in float32): it trains only reduced, in
# train_families_reference.
TRAIN_FAMILIES = (("zamba2-2.7b", None, "adamw"), ("xlstm-125m", None, "adamw"),
                  ("hubert-xlarge", None, "adamw"),
                  ("phi3.5-moe-42b-a6.6b", 2, "adamw"),
                  ("qwen2-vl-72b", 2, "adafactor"))
TRAIN_FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "zamba2-2.7b",
                      "xlstm-125m", "qwen2-vl-72b", "hubert-xlarge")
# zero by design (tests/test_torch_train_families.py: zero in JAX too):
# hubert's token embedding, trained on embeds
TRAIN_ZERO_BY_DESIGN = {"hubert-xlarge": {"embed"}}
TRAIN_XLSTM_GN_TOL = 5e-5       # tests/test_torch_train_families.py, steps 2-3


def bad_grad_leaves(grads) -> Tuple[list, int]:
    """The leaves (each layer's slice of a stacked leaf) whose gradient is
    zero or not finite, and how many were checked."""
    from repro_torch import tree
    bad, n = [], 0
    for key, g in zip(tree.key_paths(grads), tree.leaves(grads)):
        stacked = key.startswith("layers/")
        rows = g.reshape(g.shape[0], -1) if stacked else g.reshape(1, -1)
        fin = torch.isfinite(rows).all(1).tolist()
        nz = (rows.abs().amax(1) > 0).tolist()
        bad += [f"{key}[{i}]" if stacked else key
                for i, (f, z) in enumerate(zip(fin, nz)) if not (f and z)]
        n += len(fin)
    return bad, n


def phase_train_families(log) -> None:
    """Each family beyond dense trained at full width on the card
    (TRAIN_FAMILIES: depth cut where the state would not fit): float32
    parameters from seed 0, bf16 compute, batch 8 x seq 128 from
    lm_batches(seed=0) (hubert: seeded numpy embeds (8, 128, 1280) with
    cluster labels in [0, 504), family_batches), the launcher's learning
    rate and warmup (3e-4, 1), 6 steps of training.make_train_step, launch
    counts zeroed before step 1 and read after step 6 (none of the port's
    kernels may launch).  After step 1
    every leaf (each layer's slice of a stacked leaf) has a finite, nonzero
    gradient, but hubert's embed (zero by design, as in JAX); every loss is
    finite and the last below the first.  Seconds a step (median of steps
    3-6), tokens/s, peak memory, the model-FLOPs share (6 x active
    parameters x tokens over the step time, of 989 TFLOP/s; the MoE counts
    its top-k experts) and the MoE's dropped token slots a step."""
    import dataclasses
    import gc
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model, moe
    from repro_torch.training import init_train_state, make_train_step

    t_phase = time.perf_counter()
    n_steps, B, S = 6, 8, 128
    for arch, depth, opt in TRAIN_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full = get_arch(arch)
        cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
        model = build_model(cfg, device="cuda")
        tc = TrainConfig(optimizer=opt, warmup_steps=max(n_steps // 10, 1))
        step = make_train_step(model, tc)
        batches = family_batches(cfg, B, S, n_steps, tc.seed, "cuda")
        state = init_train_state(model, tc, tc.seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        times, mets, drops = [], [], []
        reset_launch_counts()
        for i, b in enumerate(batches):
            with moe.count_drops() as dr:
                t1 = time.perf_counter()
                state, met = step(state, b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            mets.append({k: float(v) for k, v in met.items()})
            drops.append(int(sum(int(x) for x in dr)))
            if i == 0:
                _, _, grads = step.compute_grads(state["params"], batches[1])
                bad, n_leaves = bad_grad_leaves(grads)
                del grads
        launches = launch_counts()
        losses = [m["loss"] for m in mets]
        step_s = float(np.median(times[2:]))
        active = cfg.active_param_count()
        flops = 6 * active * B * S
        want_zero = TRAIN_ZERO_BY_DESIGN.get(arch, set())
        rec = {"phase": "train_families", "arch": arch, "family": cfg.family,
               "cut": None if depth is None else {"n_layers": [full.n_layers, depth]},
               "optimizer": opt, "compute_dtype": tc.compute_dtype,
               "params": cfg.param_count(), "active_params": active,
               "batch": B, "seq": S, "steps": n_steps, "init_s": init_s,
               "losses": losses, "grad_norms": [m["grad_norm"] for m in mets],
               "aux": [m["aux"] for m in mets], "lrs": [m["lr"] for m in mets],
               "step_s": times, "step_s_median_3_6": step_s,
               "tokens_per_s": B * S / step_s, "flops_per_step": flops,
               "mfu_bf16": flops / step_s / BF16_FLOPS,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "grad_leaves_checked": n_leaves, "zero_grad_leaves": bad,
               "launches": launches, "seconds": time.perf_counter() - t0}
        if cfg.is_moe:
            rec["dropped_slots_per_step"] = drops
            rec["slots_per_step"] = B * S * cfg.top_k * cfg.n_layers
        emit(rec, log)
        if set(bad) != want_zero:
            raise RuntimeError(f"train_families {arch}: zero or non-finite gradients "
                               f"after step 1: {sorted(set(bad) ^ want_zero)}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise RuntimeError(f"train_families {arch}: losses {losses}")
        if any(launches.values()):
            raise RuntimeError(f"train_families {arch}: kernels launched {launches}")
        del state, step, batches, model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_families", "seconds": time.perf_counter() - t_phase}, log)


def phase_train_families_reference(log) -> None:
    """compare_train for each non-dense arch, reduced, in float32 compute:
    3 steps on the card against 3 on the CPU within
    tests/test_torch_train_families.py's envelopes (loss and grad norm 1e-5
    relative, the xLSTM's grad norm from step 2 on TRAIN_XLSTM_GN_TOL; MoE
    aux 1e-5; parameters within 2 * sum(lr), at most 1e-4 of them past
    1e-5 + 1e-5 |p|), with no kernel of the port launched."""
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    tc = TrainConfig(compute_dtype="float32", learning_rate=1e-3, warmup_steps=2)
    reset_launch_counts()
    out = {arch: compare_train(tc, arch=arch) for arch in TRAIN_FAMILY_ARCHS}
    launches = launch_counts()
    emit({"phase": "train_families_reference", "tol": TRAIN_F32_TOL,
          "xlstm_later_grad_norm_tol": TRAIN_XLSTM_GN_TOL, "errs": out,
          "launches": launches, "seconds": time.perf_counter() - t0}, log)
    for arch, e in out.items():
        later = TRAIN_XLSTM_GN_TOL if arch == "xlstm-125m" else TRAIN_F32_TOL
        ok = (e["loss_rel"] <= TRAIN_F32_TOL and e["aux_abs"] <= TRAIN_F32_TOL
              and e["grad_norm_rel"] <= TRAIN_F32_TOL and e["grad_norm_rel_later"] <= later
              and e["params_max_abs"] <= e["two_sum_lr"]
              and e["share_past_tol"] <= TRAIN_F32_SHARE)
        if not ok:
            raise RuntimeError(f"train_families_reference {arch}: card vs CPU outside "
                               f"the envelope: {e}")
    if any(launches.values()):
        raise RuntimeError(f"train_families_reference: kernels launched {launches}")


# phase lm_mesh: the LM stack placed over a mesh.  The placed step's depth cut
# (16 of gemma2-2b's 26 layers, P = 7.3 GB of float32 parameters): four
# places on one card hold the parameters twice (replicated over data) and m
# and v once (ZeRO-1), 4P; a step adds the owners' float32 accumulators (P
# over the four places) and a replica's gradients (P over its two places),
# 6P = 44 GB before activations; the whole depth (P = 10.4 GB) would need 62
# GB, and the hold, which gathers the state and the gradients whole beside
# it, 93 GB.  The FSDP run (the weights cut over the data places too) holds
# the parameters once, 3P.  The launcher runs 1 layer (P = 2.7 GB): it
# writes the whole state to disk twice (steps 0 and 4), 8 GB a checkpoint.
# The re-mesh case is reduced gemma2-2b.
LM_MESH_LAYERS = 16
LM_MESH_FSDP_STEPS = 2     # the FSDP run's steps (fsdp_size 2), held and timed
LM_MESH_STEPS = 5          # steps 2-4 timed, step 5 traced
LM_MESH_LAUNCHER_LAYERS = 1
LM_MESH_PROMPT = (4, 512)  # the placed prefill's batch and tokens
LM_MESH_DECODE = 16        # teacher-forced decode steps after it
LM_MESH_LOGIT_TOL = 1e-4   # placed prefill and decode against one device
META_PEAK_TOL = 0.10       # the dry run's meta peak against the card's growth
# (arch, shape, multi-pod); launch/dryrun.lower_cell runs a cell of alike
# stacked layers at three depths and continues it to its own
# (``extrapolation_depths``), any other at its full depth
DRYRUN_CELLS = (("gemma2-2b", "train_4k", False),
                ("qwen2-vl-72b", "prefill_32k", False),
                ("zamba2-2.7b", "long_500k", False),
                ("kimi-k2-1t-a32b", "decode_32k", True),
                ("qwen2-vl-72b", "train_4k", False))
CARD_BYTES = 80 * 2 ** 30  # an H100's memory: kimi-k2 decode_32k's place must fit it
PLACE0_TOL = 0.10          # an FSDP train cell's place 0 against its largest other place
DRYRUN_BUDGET_S = 120
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)     # phase train_resume's envelope
HOLD_NORM_TOL = 1e-6       # the placed clip norm's partial sums against one sum
MOE_FWD_TOL, MOE_GRAD_TOL = 1e-4, 1e-3     # tests/test_moe_dispatch.py
SEQ_PAR_TOL = 1e-4                         # tests/test_distributed.py:106


def block_bytes(placed_tree) -> list:
    """Bytes each place holds of a tree of Placed leaves."""
    from repro_torch import tree
    leaves = tree.leaves(placed_tree)
    return [sum(t.blocks[i].numel() * t.blocks[i].element_size() for t in leaves)
            for i in range(len(leaves[0].blocks))]


def mesh_train_setup(cfg, tc, D: int, M: int, devices, B: int, S: int, fsdp: int = 0):
    """(model, placed step, placed state, rules) of a (D, M) mesh over
    ``devices``, the state from seed tc.seed, as the launcher builds them
    (``fsdp``: the weights cut over the data places too, ``param_specs``'
    fsdp_size)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh_rules import make_rules
    from repro_torch.distributed.params import batch_specs, opt_specs, param_specs
    from repro_torch.distributed.sharding import AxisRules, P
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state
    from repro_torch.training.train_step import make_placed_train_step

    model = build_model(cfg, device=devices[0])
    mesh = make_host_mesh(D, M, devices=devices)
    shp = ShapeConfig("cli", S, B, "train")
    rules_d = make_rules(cfg, shp, model_size=M, dp_size=D)
    rules = AxisRules(rules_d)
    state = init_train_state(model, tc, tc.seed)
    ps = param_specs(state["params"], cfg, rules, M, fsdp)
    os_ = opt_specs(state["opt"], ps, cfg, rules, mesh_shape_dict(mesh), tc.zero1)
    step = make_placed_train_step(model, tc, mesh, {"params": ps, "opt": os_, "step": P()},
                                  batch_specs(cfg, shp, rules))
    return model, step, step.place_state(state), rules_d


def lm_mesh_placed(cfg, tc, devices, batches, fsdp: int = 0,
                   trace: bool = True) -> Tuple[dict, list]:
    """One placed step a batch on (2, 2) over ``devices`` (``fsdp`` as
    ``mesh_train_setup`` takes it), the last under torch.profiler where
    ``trace``.  The record (bytes between places a step by kind, the growth
    of the card's allocated memory over one step) and the final parameters
    gathered to ``devices[0]`` (None without the trace)."""
    import gc
    from repro_torch import tree
    from repro_torch.distributed.sharding import (gather, reset_transfer_counts,
                                                  transfer_counts, use_rules)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, step, state, rules_d = mesh_train_setup(cfg, tc, 2, 2, devices, 8, 128, fsdp)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    times, mets, moved, growth = [], [], [], []

    def one(b):
        nonlocal state
        reset_transfer_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        growth.append(torch.cuda.max_memory_allocated() - base)
        moved.append(transfer_counts())
        mets.append({k: float(v) for k, v in met.items()})

    with use_rules(rules_d):
        for b in batches[:-1] if trace else batches:
            one(b)
        traced = traced_window(lambda: one(batches[-1])) if trace else None
    step_s = float(np.median(times[1:-1] if trace else times[1:]))
    rec = {"devices": [str(d) for d in devices], "fsdp": fsdp, "setup_s": setup_s,
           "step_s": times,
           "losses": [m["loss"] for m in mets], "grad_norms": [m["grad_norm"] for m in mets],
           "step_s_median_untraced": step_s, "tokens_per_s": 8 * 128 / step_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "step_growth_bytes": growth,
           "param_bytes_per_place": block_bytes(state["params"]),
           "m_bytes_per_place": block_bytes(state["opt"]["m"]),
           "v_bytes_per_place": block_bytes(state["opt"]["v"]),
           "bytes_between_places_per_step": [c["between_places"] for c in moved],
           "bytes_by_kind_last_step": moved[-2]["bytes"],
           "hand_overs_by_kind_last_step": moved[-2]["count"]}
    if trace:
        rec.update({"device_launches_traced_step": traced["device_events"],
                    "busy_share_traced_step": traced["busy_share_traced"],
                    "top_device_traced_step": traced["top_device"]})
    final = [gather(p, devices[0]) for p in tree.leaves(state["params"])] if trace else None
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec, final


def lm_mesh_hold(cfg, tc, devices, batches, fsdp: int = 0) -> Tuple[dict, list]:
    """The placed step of ``lm_mesh_placed`` again from the same seed and
    batches, each step in its two halves (``compute_grads``, then
    ``apply_grads``): at every step the one-device update (the optimizer on
    the state gathered whole) of the placed step's own gradients gathered
    whole, at the placed step's clip scale (from its norm), held against the
    placed update (each place's reduced block clipped, AdamW on it, ZeRO-1's
    hand-over) on every parameter, first and second moment: bit for bit,
    else within RESUME_TOL (a failure raises); the placed clip norm (its
    blocks' sums of squares) against the one-device norm of the same
    gradients within HOLD_NORM_TOL.  The record (the losses too) and the
    step-1 gradients on the host."""
    import gc
    from repro_torch import tree
    from repro_torch.distributed.sharding import gather, use_rules
    from repro_torch.training.optim import lr_schedule, make_optimizer
    from repro_torch.training.train_step import global_norm

    t0 = time.perf_counter()
    _, step, state, rules_d = mesh_train_setup(cfg, tc, 2, 2, devices, 8, 128, fsdp)
    _, opt_update = make_optimizer(tc)
    dev = devices[0]
    rec = {"fsdp": fsdp, "steps": 0, "leaves": 0, "leaves_bitwise": 0, "max_abs_err": 0.0,
           "losses": [], "grad_norm_rel_err": 0.0}
    grads1 = None

    def placed_leaves():
        return [tree.leaves(state["params"]), tree.leaves(state["opt"]["m"]),
                tree.leaves(state["opt"]["v"])]

    with use_rules(rules_d):
        for b in batches:
            loss, met, grads = step.compute_grads(state["params"], b)
            whole_g = [gather(g, dev) for g in grads]
            if grads1 is None:
                grads1 = [g.cpu() for g in whole_g]
            before = [[gather(t, dev) for t in leaf] for leaf in zip(*placed_leaves())]
            lr, opt_step = lr_schedule(tc, state["step"]), state["opt"]["step"]
            state, met = step.apply_grads(state, loss, met, grads)
            del grads
            gn = met["grad_norm"]
            own = float(global_norm(whole_g))
            rec["grad_norm_rel_err"] = max(rec["grad_norm_rel_err"], abs(float(gn) - own) / own)
            rec["losses"].append(float(loss))
            scale = torch.clamp_max(tc.grad_clip / torch.clamp_min(gn, 1e-9), 1.0).to(dev)
            for n, w in enumerate(before):
                g, whole_g[n] = whole_g[n].float().mul_(scale), None
                opt_update([g], {"m": [w[1]], "v": [w[2]], "step": opt_step}, [w[0]], lr)
                del g
            for name, ws, ps in zip(("params", "m", "v"), zip(*before), placed_leaves()):
                for n, (w, p) in enumerate(zip(ws, ps)):
                    got = gather(p, dev)
                    rec["leaves"] += 1
                    if torch.equal(got, w):
                        rec["leaves_bitwise"] += 1
                        continue
                    rec["max_abs_err"] = max(rec["max_abs_err"], max_abs(got, w))
                    assert_close(got, w, f"lm_mesh hold step {rec['steps'] + 1}: placed {name} "
                                 f"leaf {n} against the one-device update", **RESUME_TOL)
            del before, whole_g
            rec["steps"] += 1
    rec["update_bitwise"] = rec["leaves"] == rec["leaves_bitwise"]
    rec["seconds"] = time.perf_counter() - t0
    if rec["grad_norm_rel_err"] > HOLD_NORM_TOL:
        raise RuntimeError(f"lm_mesh hold: the placed clip norm {rec['grad_norm_rel_err']} "
                           f"from the one-device norm of the same gradients")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec, grads1


def lm_mesh_meta_peak(cfg, tc, fsdp: int = 0) -> dict:
    """The dry run's count of the same placed step (2x2, batch 8 x 128,
    ``fsdp`` as ``mesh_train_setup`` takes it) on the meta device: the state
    placed from the host first, then one step under
    ``launch/dryrun.PlaceCount``; its peak as one card holding every place
    would hold it, and each place's."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh_rules import make_rules
    from repro_torch.distributed.params import batch_specs, opt_specs, param_specs
    from repro_torch.distributed.sharding import AxisRules, P, use_rules
    from repro_torch.launch.dryrun import PlaceCount, from_host
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
    from repro_torch.launch.specs import abstract_state
    from repro_torch.models import build_model
    from repro_torch.training.train_step import make_placed_train_step

    t0 = time.perf_counter()
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    shp = ShapeConfig("cli", 128, 8, "train")
    rules_d = make_rules(cfg, shp, model_size=2, dp_size=2)
    rules = AxisRules(rules_d)
    state = abstract_state(cfg, tc)
    ps = param_specs(state["params"], cfg, rules, 2, fsdp)
    specs = {"params": ps, "opt": opt_specs(state["opt"], ps, cfg, rules,
                                            mesh_shape_dict(mesh), tc.zero1), "step": P()}
    step = make_placed_train_step(build_model(cfg, device="meta"), tc, mesh, specs,
                                  batch_specs(cfg, shp, rules))
    batch = {k: torch.empty((8, 128), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    with use_rules(rules_d):
        state = step.place_state(from_host(state, specs, mesh))
        count = PlaceCount(mesh.size)
        with count:
            step(state, batch)
    return {"peak_bytes_one_device": count.one_peak, "peak_bytes_per_place": count.peak,
            "flops_per_place": count.flops, "seconds": time.perf_counter() - t0}


def lm_mesh_prefill_decode(cfg, devices) -> dict:
    """The placed prefill (LM_MESH_PROMPT, cache placed by cache_specs) and
    LM_MESH_DECODE teacher-forced decode steps of ``cfg`` at full width on
    (2, 2) places over ``devices``, against the one-device run (logits within
    LM_MESH_LOGIT_TOL); the flash kernel per place against its plain version
    at a place's shapes.  Flash launches of the placed prefill counted from
    0: 16 layers x 2 replicas x 2 model places."""
    import gc
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh_rules import make_rules
    from repro_torch.distributed.params import batch_specs, cache_specs, param_specs
    from repro_torch import tree
    from repro_torch.distributed.sharding import (AxisRules, NamedSharding, place,
                                                  reset_transfer_counts, transfer_counts,
                                                  use_rules)
    from repro_torch.distributed.tensor_parallel import (make_placed_decode,
                                                         make_placed_prefill)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import params_tree

    B, S = LM_MESH_PROMPT
    n_dec, dev = LM_MESH_DECODE, torch.device(devices[0])
    Smax = S + n_dec                    # the cache: the prompt and every decoded token
    model = build_model(cfg, device=dev)
    params = params_tree(model.init_params(0))
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (B, Smax), generator=gen, device=dev)
    with torch.no_grad():
        lg, _, cache = model.forward(params, {"tokens": toks[:, :S]}, build_cache=True,
                                     max_seq=Smax)
        want = [lg[:, -1].clone()]
        del lg
        for t in range(S, Smax):
            lg, cache = model.decode_step(params, toks[:, t:t + 1], cache)
            want.append(lg[:, 0])
    ref_cache_k = cache["k"].clone()
    del cache
    gc.collect()
    mesh = make_host_mesh(2, 2, devices=devices)
    rules_d = make_rules(cfg, ShapeConfig("p", Smax, B, "prefill"), model_size=2, dp_size=2)
    rules = AxisRules(rules_d)
    ps = param_specs(params, cfg, rules, 2)
    cs = cache_specs(model.init_cache(1, 1, torch.float32), cfg, rules)
    got, times = [], {}
    placed = tree.tree_map(lambda t, s: place(t, NamedSharding(mesh, s)), params, ps)
    del params
    gc.collect()
    with use_rules(rules_d), torch.no_grad():
        prefill = make_placed_prefill(cfg, mesh, ps, batch_specs(
            cfg, ShapeConfig("p", S, B, "prefill"), rules), cs, max_seq=Smax)
        decode = make_placed_decode(cfg, mesh, ps, rules.spec(("batch", None)))
        reset_launch_counts()
        reset_transfer_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, pcache = prefill(placed, {"tokens": toks[:, :S]})
        torch.cuda.synchronize()
        times["prefill_s"] = time.perf_counter() - t0
        launches = launch_counts()
        moved_prefill = transfer_counts()
        got.append(lg[:, 0])
        reset_transfer_counts()
        t0 = time.perf_counter()
        for t in range(S, Smax):
            lg, pcache = decode(placed, toks[:, t:t + 1], pcache)
            got.append(lg[:, 0])
        torch.cuda.synchronize()
        times["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / n_dec
        moved_decode = transfer_counts()
    from repro_torch.distributed.sharding import gather
    cache_err = max_abs(gather(pcache["k"], dev), ref_cache_k)
    errs = [max_abs(a, b) for a, b in zip(got, want)]
    # the kernel at a place's shapes: B/2 rows, H/2 q heads, K/2 kv heads
    H, K, D = cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.hd
    q = torch.randn((B // 2, H, S, D), generator=gen, device=dev)
    kv = [torch.randn((B // 2, K, S, D), generator=gen, device=dev) for _ in range(2)]
    kw = dict(causal=True, window=cfg.window, softcap=cfg.attn_softcap)
    flash_err = max_abs(flash_attention(q, *kv, **kw), flash_attention_ref(q, *kv, **kw))
    rec = {"batch": B, "prompt": S, "decode_steps": n_dec, "tol": LM_MESH_LOGIT_TOL,
           "logits_max_abs_err": max(errs), "prefill_logits_err": errs[0],
           "cache_k_err": cache_err, "flash_launches_prefill": launches["flash_attention"],
           "launches_prefill": launches,
           "bytes_between_places_prefill": moved_prefill["between_places"],
           "bytes_by_kind_prefill": moved_prefill["bytes"],
           "bytes_between_places_decode_per_step": moved_decode["between_places"] / n_dec,
           "flash_per_place": {"shape": {"B": B // 2, "H": H, "K": K, "S": S, "D": D, **kw},
                               "max_abs_err": flash_err}, **times}
    want_launches = cfg.n_layers * 2 * 2
    if (max(errs) > LM_MESH_LOGIT_TOL or cache_err > LM_MESH_LOGIT_TOL
            or not all(bool(torch.isfinite(t).all()) for t in got)):
        raise RuntimeError(f"lm_mesh: placed prefill/decode against one device: {errs}, "
                           f"cache {cache_err}")
    if launches["flash_attention"] != want_launches:
        raise RuntimeError(f"lm_mesh: the placed prefill launched flash "
                           f"{launches['flash_attention']} times, not {want_launches}")
    if not flash_err <= LM_REF_TOL:
        raise RuntimeError(f"lm_mesh: flash at a place's shapes against plain: {flash_err}")
    del placed, pcache, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_mesh_moe(log_rec: dict, cfg=None, dev: str = "cuda", tokens=(4, 512)) -> None:
    """moe_ffn_local at phi3.5-moe's full width (d 4096, 16 experts, top-2,
    d_ff_expert 6400), one layer, 4 x 512 tokens, on (2, 4) places of
    cuda:0: at capacity factor 8 against the dense dispatch (forward and
    every gradient of sum(y^2) + 0.01 aux); at the config's own factor each
    dispatch's dropped slots; forward ms of both."""
    import dataclasses
    import gc
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.distributed import flags
    from repro_torch.distributed.sharding import (reset_transfer_counts,
                                                  transfer_counts, use_rules)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    cfg = cfg or get_arch("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: (v.detach() if torch.is_tensor(v) else {kk: vv.detach() for kk, vv in v.items()})
         for k, v in moe.moe_init(gen, cfg, torch.float32).items()}
    x = torch.randn((*tokens, cfg.d_model), generator=gen, device=dev) * 0.5
    mesh = make_host_mesh(2, 4, devices=[dev] * 8)
    rules = {"batch": ("data",), "experts": "model", "expert_cap": ("data",),
             "ff": None, "fsdp": None}

    def local():
        return flags.use_local_moe_dispatch(mesh, ("data",), "model")

    def run(c, ctx):
        leaves = [t.clone().requires_grad_(True) for t in tree.leaves(p)]
        xx = x.clone().requires_grad_(True)
        with torch.enable_grad(), ctx:
            y, aux = moe.moe_ffn(tree.unflatten(p, leaves), xx, c)
            grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, leaves + [xx])
        return y.detach(), grads

    cf8 = dataclasses.replace(cfg, capacity_factor=8.0)
    with use_rules(rules):
        y_d, g_d = run(cf8, contextlib.nullcontext())
        reset_transfer_counts()
        y_l, g_l = run(cf8, local())
        moved = transfer_counts()["between_places"]
        fwd_err = max_abs(y_l, y_d)
        grad_err = [max_abs(a, b) for a, b in zip(g_l, g_d)]
        grad_scale = [float(b.abs().max()) for b in g_d]
        del g_d, g_l
        gc.collect()
        drops = {}
        with torch.no_grad():
            for cf in (cfg.capacity_factor, 1.0):
                for name, ctx in (("dense", contextlib.nullcontext()), ("local", local())):
                    with ctx, moe.count_drops() as dr:
                        moe.moe_ffn(p, x, dataclasses.replace(cfg, capacity_factor=cf))
                    drops[f"{name}_cf{cf}"] = [int(d) for d in dr]
            ms = {"dense": cuda_ms(lambda: moe.moe_ffn(p, x, cf8), reps=3)}
            with local():
                ms["local"] = cuda_ms(lambda: moe.moe_ffn(p, x, cf8), reps=3)
    log_rec["moe_local"] = {
        "arch": cfg.name, "d_model": cfg.d_model, "experts": cfg.n_experts,
        "top_k": cfg.top_k, "d_ff_expert": cfg.d_ff_expert,
        "tokens": tokens[0] * tokens[1], "places": "2x4", "fwd_max_abs_err": fwd_err,
        "grad_max_abs_err": grad_err, "grad_max_abs": grad_scale,
        "bytes_between_places_fwd_bwd": moved,
        "capacity_factor_own": cfg.capacity_factor, "dropped_slots": drops,
        "slots": tokens[0] * tokens[1] * cfg.top_k, "fwd_ms_cf8": ms}
    if not fwd_err <= MOE_FWD_TOL or not max(grad_err) <= MOE_GRAD_TOL:
        raise RuntimeError(f"lm_mesh: local MoE dispatch against dense: forward {fwd_err}, "
                           f"gradients {grad_err}")
    if any(len(d) != 1 for d in drops.values()):
        raise RuntimeError(f"lm_mesh: a dispatch not counted once: {drops}")
    del p, x
    gc.collect()
    torch.cuda.empty_cache()


def lm_mesh_seq_parallel(devices, shape=(4, 8, 4, 256, 8192)) -> dict:
    """Sequence-parallel decode at gemma2-2b's decode shape (B=4, H=8, K=4,
    D=256, an 8192-token cache, float32; JAX's combine has no softcap, so
    the reference takes deepseek-7b's config, as tests/test_distributed.py)
    over len(devices) places, against decode_attention."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.seq_parallel import make_seq_parallel_decode
    from repro_torch.distributed.sharding import Mesh, NamedSharding, P, place
    from repro_torch.models.attention import decode_attention

    B, H, K, D, S = shape
    dev = torch.device(devices[0])
    gen = torch.Generator(device=dev).manual_seed(3)
    q, kc, vc = (torch.randn(s, generator=gen, device=dev)
                 for s in ((B, 1, H, D), (B, S, K, D), (B, S, K, D)))
    cache_len = torch.tensor([S, S * 3 // 4, S // 3 + 1, 17][:B], device=dev)
    cfg = get_arch("deepseek-7b")
    want = decode_attention(q, kc, vc, cfg, cache_len, window=0)
    mesh = Mesh(devices, ("data",))
    kv_spec = P(None, "data", None, None)
    fn = make_seq_parallel_decode(mesh, ("data",), kv_spec, P(None, None, None, None))
    kp, vp = (place(t, NamedSharding(mesh, kv_spec)) for t in (kc, vc))
    got = fn(q, kp, vp, cache_len)
    err = max_abs(got, want)
    rec = {"devices": [str(d) for d in devices], "shape": [B, H, K, D, S],
           "cache_len": cache_len.tolist(), "max_abs_err": err,
           "ms": cuda_ms(lambda: fn(q, kp, vp, cache_len), reps=10),
           "decode_attention_ms": cuda_ms(
               lambda: decode_attention(q, kc, vc, cfg, cache_len, window=0), reps=10)}
    if not err <= SEQ_PAR_TOL:
        raise RuntimeError(f"lm_mesh: sequence-parallel decode against decode_attention: {err}")
    return rec


def lm_mesh_remesh(root: Path, dev: str = "cuda:0") -> dict:
    """Reduced gemma2-2b's placed state (2x2 on cuda:0, ZeRO-1, after one
    step) saved, then restored on 4x1 and 1x1 by their own specs: every
    leaf bit for bit, every block its slice."""
    from repro_torch import tree
    from repro_torch.configs import ShapeConfig, TrainConfig, get_arch, reduced
    from repro_torch.distributed.mesh_rules import make_rules
    from repro_torch.distributed.params import opt_specs, param_specs
    from repro_torch.distributed.sharding import (AxisRules, Placed, gather,
                                                  named_shardings, use_rules)
    from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
    from repro_torch.training import CheckpointManager

    cfg = reduced(get_arch("gemma2-2b"))
    tc = TrainConfig(zero1=True, warmup_steps=1)
    _, step, state, rules_d = mesh_train_setup(cfg, tc, 2, 2, [dev] * 4, 8, 32)
    with use_rules(rules_d):
        state, _ = step(state, train_batches(cfg.vocab, 8, 32, 1, 0, dev)[0])
    mgr = CheckpointManager(str(root / "remesh"))
    mgr.save(1, state)
    saved = [gather(t, dev) if isinstance(t, Placed) else t for t in tree.leaves(state)]
    out = {}
    for D, M in ((4, 1), (1, 1)):
        mesh = make_host_mesh(D, M, devices=[dev] * (D * M))
        rules = AxisRules(make_rules(cfg, ShapeConfig("cli", 32, 8, "train"),
                                     model_size=M, dp_size=D))
        ps = param_specs(state["params"], cfg, rules, M)
        os_ = opt_specs(state["opt"], ps, cfg, rules, mesh_shape_dict(mesh), tc.zero1)
        os_["step"] = None
        shardings = named_shardings(mesh, {"params": ps, "opt": os_, "step": None})
        restored, _ = mgr.restore(state, shardings=shardings)
        same = True
        for t, want in zip(tree.leaves(restored), saved):
            if isinstance(t, Placed):
                same &= torch.equal(gather(t, dev), want) and all(
                    torch.equal(t.blocks[i], want[t.slices(i)]) for i in range(D * M))
            else:
                same &= torch.equal(t, want)
        out[f"{D}x{M}"] = same
    if not all(out.values()):
        raise RuntimeError(f"lm_mesh: re-meshed checkpoint differs: {out}")
    return out


def phase_lm_mesh(log) -> int:
    """The LM stack placed over a mesh, places repeated on cuda:0 (and a
    card a place where the host has four): the placed train step with the
    dense layers' compute split over the model places (gemma2-2b at full
    width, LM_MESH_LAYERS layers, float32 compute, AdamW, ZeRO-1, 2x2, batch
    8 x 128 from lm_batches(seed=0), LM_MESH_STEPS steps: 2-4 timed, the
    last traced) against the one-device step at microbatches=2: every
    step's loss and the step-1 gradients at the optimizer's scale within
    RESUME_TOL, and at every step of a second run the placed update against
    the one-device update of the same gradients at the placed clip scale
    (``lm_mesh_hold``; the final parameters of the two runs' error reported
    beside: AdamW turns a gradient's rounding below its eps into a step of
    lr |g| / eps); the same with the weights cut over the data places too
    (``fsdp_size`` 2, LM_MESH_FSDP_STEPS steps); the dry run's meta peak of
    each step against the card's growth (META_PEAK_TOL);
    the placed prefill and LM_MESH_DECODE decode steps against one device,
    flash per place; moe_ffn_local at phi3.5-moe's width; sequence-parallel
    decode at gemma2-2b's decode shape over 4 places; a re-meshed
    checkpoint; the launcher's --mesh 2x2.  The five kernels' counts stay 0
    over the training paths; the placed prefill's flash launches are counted
    apart.  Returns those launches."""
    import dataclasses
    import gc
    import io
    import shutil
    import tempfile
    from repro_torch import tree
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state, make_train_step
    from repro_torch.training.train_step import global_norm

    t_phase = time.perf_counter()
    part_s, t_last = {}, [t_phase]

    def lap(name):                          # the phase's seconds by part
        now = time.perf_counter()
        part_s[name], t_last[0] = now - t_last[0], now

    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    cfg = dataclasses.replace(get_arch("gemma2-2b"), n_layers=LM_MESH_LAYERS)
    tc = TrainConfig(zero1=True, warmup_steps=1, compute_dtype="float32")
    batches = train_batches(cfg.vocab, 8, 128, LM_MESH_STEPS, tc.seed, "cuda")
    cards = torch.cuda.device_count()
    runs = {"one_card": ["cuda:0"] * 4}
    if cards >= 4:
        runs["card_a_place"] = [f"cuda:{i}" for i in range(4)]
    rec = {"phase": "lm_mesh", "arch": cfg.name, "layers": cfg.n_layers,
           "layers_full": get_arch("gemma2-2b").n_layers, "params": cfg.param_count(),
           "batch": 8, "seq": 128, "mesh": "2x2", "optimizer": tc.optimizer,
           "zero1": tc.zero1, "compute_dtype": tc.compute_dtype, "placed": {},
           "cards": cards}
    finals, grads1 = {}, {}
    rec["hold"] = {}
    for name, devices in runs.items():     # the hold first: it holds ~65 GiB on one card
        rec["hold"][name], grads1[name] = lm_mesh_hold(cfg, tc, devices, batches)
        lap(f"hold_{name}")
        rec["placed"][name], finals[name] = lm_mesh_placed(cfg, tc, devices, batches)
        lap(f"placed_{name}")
    # the weights cut over the data places too (FSDP): held the same way
    fsdp_batches = batches[:LM_MESH_FSDP_STEPS]
    rec["fsdp"] = {"fsdp_size": 2, "steps": LM_MESH_FSDP_STEPS}
    rec["fsdp"]["hold"], grads1["fsdp"] = lm_mesh_hold(cfg, tc, runs["one_card"],
                                                       fsdp_batches, fsdp=2)
    lap("hold_fsdp")
    rec["fsdp"]["placed"], _ = lm_mesh_placed(cfg, tc, runs["one_card"], fsdp_batches,
                                              fsdp=2, trace=False)
    lap("placed_fsdp")

    # the one-device step at microbatches = 2 from the same seed and batches
    ref_tc = dataclasses.replace(tc, microbatches=2)
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, ref_tc, ref_tc.seed)
    step = make_train_step(model, ref_tc)
    _, _, want1 = step.compute_grads(state["params"], batches[0])
    want1 = tree.leaves(want1)
    scale = min(1.0, ref_tc.grad_clip / float(global_norm(want1)))   # the clip's
    grad_errs = {}
    for name, gl in grads1.items():
        for g, w in zip(gl, want1):
            assert_close(g.to(w.device) * scale, w * scale,
                         f"lm_mesh {name}: placed vs one-device step-1 gradients", **RESUME_TOL)
        grad_errs[name] = max(max_abs(g.to(w.device), w) * scale for g, w in zip(gl, want1))
    del want1, grads1
    gc.collect()
    times, losses = [], []

    def one(b):
        nonlocal state
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))

    for b in batches[:-1]:
        one(b)
    traced = traced_window(lambda: one(batches[-1]))
    step_s = float(np.median(times[1:-1]))
    rec["unplaced"] = {"step_s": times, "losses": losses,
                       "step_s_median_untraced": step_s, "tokens_per_s": 8 * 128 / step_s,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "device_launches_traced_step": traced["device_events"],
                       "busy_share_traced_step": traced["busy_share_traced"]}
    rec["grads1_max_abs_err_at_clip_scale"] = grad_errs
    params_err = {}
    for name, final in finals.items():
        pairs = list(zip(final, tree.leaves(state["params"])))
        params_err[name] = {
            "max_abs_err": max(max_abs(a, b) for a, b in pairs),
            "outside_envelope": sum(int(((a - b).abs() > RESUME_TOL["atol"]
                                         + RESUME_TOL["rtol"] * b.abs()).sum())
                                    for a, b in pairs),
            "of": sum(b.numel() for _, b in pairs)}
        pl = rec["placed"][name]["losses"]
        if any(abs(a - b) > RESUME_TOL["rtol"] * abs(b) for a, b in zip(pl, losses)):
            raise RuntimeError(f"lm_mesh {name}: losses {pl} against one-device {losses}")
    for run in (rec["fsdp"]["hold"], rec["fsdp"]["placed"]):
        if any(abs(a - b) > RESUME_TOL["rtol"] * abs(b) for a, b in zip(run["losses"], losses)):
            raise RuntimeError(f"lm_mesh fsdp: losses {run['losses']} against one-device "
                               f"{losses}")
    rec["params_after_steps"] = params_err
    del state, step, model, finals
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = launch_counts()
    lap("unplaced")

    meta = lm_mesh_meta_peak(cfg, tc)
    card_growth = max(rec["placed"]["one_card"]["step_growth_bytes"][1:-1])
    rec["meta_dry_run"] = {"peak_bytes_one_device": meta["peak_bytes_one_device"],
                           "card_step_growth_bytes": card_growth,
                           "ratio": meta["peak_bytes_one_device"] / card_growth,
                           "peak_bytes_per_place": meta["peak_bytes_per_place"],
                           "seconds": meta["seconds"]}
    meta_fsdp = lm_mesh_meta_peak(cfg, tc, fsdp=2)
    fsdp_growth = max(rec["fsdp"]["placed"]["step_growth_bytes"][1:])
    rec["fsdp"]["meta_dry_run"] = {"peak_bytes_one_device": meta_fsdp["peak_bytes_one_device"],
                                   "card_step_growth_bytes": fsdp_growth,
                                   "ratio": meta_fsdp["peak_bytes_one_device"] / fsdp_growth,
                                   "peak_bytes_per_place": meta_fsdp["peak_bytes_per_place"],
                                   "seconds": meta_fsdp["seconds"]}
    for name, (m, growth) in {"": (meta, card_growth), " fsdp": (meta_fsdp, fsdp_growth)}.items():
        if abs(m["peak_bytes_one_device"] / growth - 1) > META_PEAK_TOL:
            raise RuntimeError(f"lm_mesh{name}: the meta dry run's peak "
                               f"{m['peak_bytes_one_device']} against the card's step growth "
                               f"{growth}")

    lap("meta")
    rec["prefill_decode"] = lm_mesh_prefill_decode(cfg, runs["one_card"])
    lap("prefill_decode")
    reset_launch_counts()
    lm_mesh_moe(rec)
    lap("moe")
    rec["seq_parallel"] = {"one_card": lm_mesh_seq_parallel(["cuda:0"] * 4)}
    if cards >= 4:
        rec["seq_parallel"]["card_a_place"] = lm_mesh_seq_parallel(
            [f"cuda:{i}" for i in range(4)])
    lap("seq_parallel")
    root = Path(tempfile.mkdtemp(prefix="lm_mesh_"))
    try:
        rec["remesh_bitwise"] = lm_mesh_remesh(root)
        lap("remesh")
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_main(["--arch", "gemma2-2b", "--mesh", "2x2", "--steps", "4",
                        "--layers", str(LM_MESH_LAUNCHER_LAYERS), "--ckpt-every", "100",
                        "--ckpt-dir", str(root / "launcher")])
        line = out.getvalue().strip().splitlines()[-1]
        rec["launcher"] = {"layers": LM_MESH_LAUNCHER_LAYERS, "line": line,
                           "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lap("launcher")
    rec["launches"] = {k: train_launches[k] + v for k, v in launch_counts().items()}
    rec["seconds"] = time.perf_counter() - t_phase
    rec["seconds_by_part"] = part_s
    one_card = rec["placed"]["one_card"]
    rec["summary"] = {
        "s_a_step_placed": one_card["step_s_median_untraced"],
        "s_a_step_unplaced": rec["unplaced"]["step_s_median_untraced"],
        "device_launches_traced_step": one_card["device_launches_traced_step"],
        "bytes_between_places_a_step": one_card["bytes_between_places_per_step"][-2],
        "bytes_by_kind": one_card["bytes_by_kind_last_step"],
        "peak_gib": one_card["peak_mem_gib"],
        "meta_peak_ratio": rec["meta_dry_run"]["ratio"],
        "update_held_bitwise": rec["hold"]["one_card"]["update_bitwise"],
        "grad_norm_rel_err": rec["hold"]["one_card"]["grad_norm_rel_err"],
        "fsdp": {"s_a_step": rec["fsdp"]["placed"]["step_s_median_untraced"],
                 "bytes_between_places_a_step":
                     rec["fsdp"]["placed"]["bytes_between_places_per_step"][-1],
                 "bytes_by_kind": rec["fsdp"]["placed"]["bytes_by_kind_last_step"],
                 "peak_gib": rec["fsdp"]["placed"]["peak_mem_gib"],
                 "meta_peak_bytes_per_place": meta_fsdp["peak_bytes_per_place"],
                 "meta_peak_ratio": rec["fsdp"]["meta_dry_run"]["ratio"],
                 "update_held_bitwise": rec["fsdp"]["hold"]["update_bitwise"],
                 "grad_norm_rel_err": rec["fsdp"]["hold"]["grad_norm_rel_err"]}}
    emit(rec, log)
    if not line.startswith("steps=4 restarts=0 ") or "loss=nan" in line:
        raise RuntimeError(f"lm_mesh: launcher line {line!r}")
    if any(rec["launches"].values()):
        raise RuntimeError(f"lm_mesh: kernels launched on the training paths {rec['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec["prefill_decode"]["flash_launches_prefill"]


def phase_dryrun(log) -> None:
    """The dry run (``launch/dryrun.py``) of five production cells on the
    meta device, one replica of each run and the rest counted from it:
    gemma2-2b train_4k, qwen2-vl-72b prefill_32k, zamba2-2.7b long_500k and
    qwen2-vl-72b train_4k (AdamW, bf16, ZeRO-1 and FSDP) on 16x16, kimi-k2
    decode_32k on 2x16x16; all but zamba2 run at three depths and continued
    to their own (``dryrun.extrapolation_depths``, exact where each count is
    linear in depth, which it checks).  Each cell's record and seconds printed (its
    lists a place only in the log, not printed); within DRYRUN_BUDGET_S;
    kimi-k2 decode_32k's largest place within a card (CARD_BYTES: the FSDP
    experts assembled a layer at a time), and the FSDP train cell's place 0
    within PLACE0_TOL of its largest other place (no whole gradient at
    place 0)."""
    from repro_torch.launch.dryrun import lower_cell

    t0 = time.perf_counter()
    cells = {}
    for arch, shape, mp in DRYRUN_CELLS:
        rec = lower_cell(arch, shape, mp, check_flops=False)
        cells[f"{arch}__{shape}__{'multipod' if mp else 'singlepod'}"] = rec
        brief = {k: v for k, v in rec.items() if k not in ("memory", "flops")}
        brief["memory"] = {k: v for k, v in rec["memory"].items() if "per_place" not in k}
        brief["flops"] = {k: v for k, v in rec["flops"].items() if k != "per_place"}
        print(json.dumps({"dryrun_cell": brief}), flush=True)
        if not (rec["flops"]["total"] > 0 and rec["memory"]["peak_bytes_largest_place"] > 0):
            raise RuntimeError(f"dryrun: {arch} {shape} counted nothing: {brief}")
    seconds = time.perf_counter() - t0
    emit({"phase": "dryrun", "cells": list(cells), "seconds": seconds,
          "cell_seconds": {k: r["seconds"] for k, r in cells.items()}}, log)
    log.append({"phase": "dryrun_records", "records": cells})
    if seconds > DRYRUN_BUDGET_S:
        raise RuntimeError(f"dryrun: {seconds:.1f} s over the {DRYRUN_BUDGET_S} s budget")
    kimi = cells["kimi-k2-1t-a32b__decode_32k__multipod"]["memory"]
    if kimi["peak_bytes_largest_place"] > CARD_BYTES:
        raise RuntimeError(f"dryrun: kimi-k2 decode_32k holds {kimi['peak_bytes_largest_place']} "
                           f"B at a place, more than a card's {CARD_BYTES}")
    train = cells["qwen2-vl-72b__train_4k__singlepod"]["memory"]["peak_bytes_per_place"]
    if train[0] > (1 + PLACE0_TOL) * max(train[1:]):
        raise RuntimeError(f"dryrun: qwen2-vl-72b train_4k holds {train[0]} B at place 0, "
                           f"against {max(train[1:])} at the largest other place")


def ensemble_designs(dev, x_sub, args, batches) -> dict:
    """kitnet_ae's two designs (csrc/kitnet_ae.cu), each forced, on the same
    inputs: their results equal bit for bit, and each one's device time a
    launch beside the launcher's own choice's.  On the service's net at
    each of ``batches`` records, and on random nets of k=7 AEs at m = h = 33
    (the whole net fits a block) and m = h = 64 (it does not), where the
    launcher's choice turns."""
    from repro_torch.kernels.kitnet_ae import kitnet_ensemble
    rng = np.random.default_rng(9)
    cases = [(f"service_B{b}", x_sub[:b].contiguous(), args) for b in batches]
    for mm, bs in ((33, (1024, 8192, 16384)), (64, (256, 8192))):
        kk = 7
        arrays = [rng.normal(0, 0.3, (kk, mm, mm)), rng.normal(0, 0.1, (kk, mm)),
                  rng.normal(0, 0.3, (kk, mm, mm)), rng.normal(0, 0.1, (kk, mm)),
                  (rng.random((kk, mm)) > 0.2) * 1.0]
        net = tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays)
        x = rng.uniform(0.0, 1.2, (max(bs), kk, mm)).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        cases += [(f"k7_m{mm}_h{mm}_B{b}", x[:b].contiguous(), net) for b in bs]
    out = {}
    for name, x, net in cases:
        got = {d: kitnet_ensemble(x, *net, design=d) for d in ("tile", "pair")}
        if not torch.equal(got["tile"], got["pair"]):
            raise RuntimeError(f"ensemble designs differ on {name}")
        reps = 5 if x.shape[-1] == 64 else 50
        out[name] = {"B": int(x.shape[0]), "pairs": int(x.shape[0] * x.shape[1]),
                     **{f"{d}_ms": timed(lambda: kitnet_ensemble(x, *net, design=d), reps,
                                         f"kitnet_ae_kernel_{d}")["ms"]
                        for d in ("tile", "pair")},
                     "auto_ms": timed(lambda: kitnet_ensemble(x, *net), reps,
                                      "kitnet_ae_kernel")["ms"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.detection.metrics import auc
    from repro_torch.interop import kitnet_from_arrays, kitnet_to_arrays
    from repro_torch.kernels import (FC_FULL, FLASH_ATTENTION, KERNELS,
                                     launch_counts, reset_launch_counts)
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.kitnet_ae import (kitnet_ensemble, kitnet_ensemble_ref,
                                               kitnet_score, kitnet_score_ref)
    from repro_torch.serving import DetectionService
    from repro_torch.traffic import synth_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log: list = []
    dev = torch.device("cuda")

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda}, log)

    # ---- 2. build ----
    t0 = time.perf_counter()
    secs = build_all(KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs,
          "ptxas": {k.name: [ln for ln in k.build_log.splitlines()
                             if "registers" in ln or "spill" in ln]
                    for k in KERNELS},
          "flash_instantiations": flash_build_record(FLASH_ATTENTION)}, log)

    # ---- 2b. flash-attention kernel against its plain version ----
    flash = phase_flash(dev, log)

    # ---- 3. FC kernels against their plain version ----
    step_ms = chain_step_ms(dev)
    fc, pk, st_k = phase_fc(dev, step_ms)
    emit({"phase": "fc", **fc}, log)

    # ---- 3b. sketch kernel against its plain version ----
    sk = phase_sketch(dev, pk, st_k, log)
    emit({"phase": "sketch", **sk}, log)

    # ---- 3c. single-key kernel: its path, then against its plain version ----
    single, single_launches = phase_fc_single(dev, pk, step_ms)
    emit({"phase": "fc_single", **single, "path_launches": single_launches}, log)

    # ---- 3d. the shapes past the kernels' built sizes ----
    phase_limits(dev, log)

    # ---- 4. main path ----
    n_pkts = 262_144
    t0 = time.perf_counter()
    data = synth_trace("mirai", n_train=n_pkts, n_benign_eval=n_pkts // 2,
                       n_attack=n_pkts // 2, seed=0)
    gen_s = time.perf_counter() - t0
    svc = DetectionService()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.observe_stream(data["train"], chunk=8192)
    svc.fit(seed=0, fpr=0.01)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    eval_start = svc.pkt_count
    t0 = time.perf_counter()
    idx, scores, alarms = svc.process_stream(data["eval"], chunk=8192)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches[FC_FULL.name] == 0:
        raise RuntimeError("fc_full never launched on the main path")
    n_eval = len(data["eval"]["ts"])
    check_kitnet_launches(launches, -(-n_eval // 8192), "main path")
    want_idx = np.arange(svc.epoch - 1 - eval_start % svc.epoch, n_eval,
                         svc.epoch) + eval_start
    if not np.array_equal(idx, want_idx):
        raise RuntimeError("main path record indices are not the epoch closers")
    if not (np.isfinite(scores).all() and scores.shape == idx.shape
            and alarms.shape == idx.shape):
        raise RuntimeError("main path scores are not finite or misshapen")
    labels = data["eval"]["label"][idx - eval_start]
    net = svc.net
    k, m = net.idx.shape
    h = net.params["W1"].shape[-1]
    main = {"phase": "main", "n_slots": 8192, "epoch": svc.epoch,
            "train_pkts": n_pkts, "eval_pkts": n_eval, "trace_gen_s": gen_s,
            "observe_fit_s": fit_s, "eval_s": eval_s, "eval_pps": n_eval / eval_s,
            "records": int(len(scores)), "alarms": int(alarms.sum()),
            "auc": auc(scores, labels), "threshold": svc.threshold,
            "ae": {"k": int(k), "m": int(m), "h": int(h)}, "launches": launches,
            "eval_pps_more_passes": eval_passes(svc, data["eval"]),
            "md_stage_device_launches": md_stage_launches(net, svc.threshold,
                                                          svc.md_backend, dev)}
    emit(main, log)

    # ---- 4b. the same eval stream again, traced ----
    main_trace = trace_eval(svc, data["eval"], eval_s, KERNELS)
    emit({"phase": "trace", **main_trace}, log)

    # ---- 4c. the sketch service over the same traffic, then traced ----
    sketch_launches, sketch_svc = phase_sketch_main(data, log)

    # ---- 5. ensemble kernel against its plain version ----
    B = 8192
    n_fit = len(range(svc.epoch - 1, n_pkts, svc.epoch))  # fit's training records
    rng = np.random.default_rng(2)
    x_sub = torch.from_numpy(rng.uniform(0.0, 1.2, (B, k, m)).astype(np.float32)).to(dev)
    xf = x_sub[:n_fit].contiguous()
    p = net.params
    args = (p["W1"], p["b1"], p["W2"], p["b2"], net.mask)
    r_k = kitnet_ensemble(x_sub, *args)
    md_err = max(max_abs(r_k, kitnet_ensemble_ref(x_sub, *args)),
                 max_abs(kitnet_ensemble(xf, *args), kitnet_ensemble_ref(xf, *args)))
    if not md_err <= MD_TOL:
        raise RuntimeError(f"ensemble kernel vs plain: max abs err {md_err}")
    r_c = torch.cat([kitnet_ensemble(x_sub[i:i + 37], *args) for i in range(0, 1110, 37)]
                    + [kitnet_ensemble(x_sub[1110:], *args)])
    if not torch.equal(r_c, r_k):
        raise RuntimeError("ensemble kernel: chunked scores differ from one shot")
    b_main = -(-8192 // svc.epoch)          # records per 8192-packet chunk

    def ens_cost(b):
        byts = (b * k * m + k * (2 * m * h + h + 2 * m) + b * k) * 4
        flops = b * k * (4 * m * h + 10 * m + 4 * h)
        return byts, flops

    ens = {"name": "kitnet_ae", "route": "cuda",
           "source": "src/repro_torch/csrc/kitnet_ae.cu",
           "replaces": "src/repro/kernels/kitnet_ae.py:38",
           "max_abs_err": md_err,
           **timed(lambda: kitnet_ensemble(xf, *args), 200, "kitnet_ae_kernel"),
           "plain_ms": cuda_ms(lambda: kitnet_ensemble_ref(xf, *args), reps=200),
           **bound(*ens_cost(n_fit)), "library_ms": None,
           "shape": {"B": n_fit, "k": int(k), "m": int(m), "h": int(h)},
           "B8192": timed(lambda: kitnet_ensemble(x_sub, *args), 200, "kitnet_ae_kernel"),
           "B8192_plain_ms": cuda_ms(lambda: kitnet_ensemble_ref(x_sub, *args), reps=200),
           **{f"B8192_{key}": v for key, v in bound(*ens_cost(B)).items()},
           "designs": ensemble_designs(dev, x_sub, args, (8, b_main, n_fit, 1024, 2048, 4096,
                                                          8192))}
    # the scoring kernel against its plain version, on records about the
    # net's training range (below it, inside it and up to 1.5 times past it)
    U = rng.uniform(-0.2, 1.5, (B, net.norm_min.shape[0])).astype(np.float32)
    X = net.norm_min + torch.from_numpy(U).to(dev) * (net.norm_max - net.norm_min)
    sargs = (net.idx, net.mask, p["W1"], p["b1"], p["W2"], p["b2"], p["V1"], p["c1"],
             p["V2"], p["c2"], net.norm_min, net.norm_max, net.out_min, net.out_max)
    Xs = X[:b_main].contiguous()
    s_k = kitnet_score(X, *sargs)
    s_err = max(max_abs(s_k, kitnet_score_ref(X, *sargs)),
                max_abs(kitnet_score(Xs, *sargs), kitnet_score_ref(Xs, *sargs)))
    if not s_err <= MD_TOL:
        raise RuntimeError(f"scoring kernel vs plain: max abs err {s_err}")
    s_c = torch.cat([kitnet_score(X[i:i + 37], *sargs) for i in range(0, B, 37)])
    if not torch.equal(s_c, s_k):
        raise RuntimeError("scoring kernel: chunked scores differ from one shot")
    kh = p["V1"].shape[-1]
    net_bytes = sum(t.numel() * t.element_size() for t in sargs)

    def score_cost(b):
        """Bytes (records read once, the net once, scores written once) and
        operations (the ensemble as in ens_cost, both normalisations and the
        output AE) of one scoring call on b records."""
        byts = b * net.norm_min.shape[0] * 4 + net_bytes + b * 4
        flops = (ens_cost(b)[1] + b * 5 * (net.norm_min.shape[0] + k)
                 + b * (4 * k * kh + 4 * kh + 10 * k))
        return byts, flops

    score = {"name": "kitnet_score", "route": "cuda",
             "source": "src/repro_torch/csrc/kitnet_score.cu",
             "replaces": "src/repro/kernels/kitnet_ae.py:38",
             "computes": "src/repro/detection/md_backends.py:119 (_score_pallas_jit)",
             "max_abs_err": s_err, "chunked_bitwise": True,
             **timed(lambda: kitnet_score(Xs, *sargs), 200, "kitnet_score_kernel"),
             "plain_ms": cuda_ms(lambda: kitnet_score_ref(Xs, *sargs), reps=200),
             **bound(*score_cost(b_main)), "library_ms": None,
             "shape": {"B": b_main, "F": int(net.norm_min.shape[0]), "k": int(k),
                       "m": int(m), "h": int(h), "kh": int(kh)},
             f"B{n_fit}": timed(lambda: kitnet_score(X[:n_fit], *sargs), 200,
                                "kitnet_score_kernel"),
             "B8192": timed(lambda: kitnet_score(X, *sargs), 200, "kitnet_score_kernel"),
             "B8192_plain_ms": cuda_ms(lambda: kitnet_score_ref(X, *sargs), reps=200),
             **{f"B8192_{key}": v for key, v in bound(*score_cost(B)).items()}}
    emit({"phase": "ensemble", **ens, "score": score}, log)

    # ---- 6. the service on the card against the plain versions on the CPU ----
    small = synth_trace("syn_dos", n_train=64, n_benign_eval=1024,
                        n_attack=1024, seed=3)["eval"]
    arrays = kitnet_to_arrays(net)
    outs = {}
    for where in ("cuda", "cpu"):
        s = DetectionService(epoch=64, n_slots=1024, device=where,
                             threshold=svc.threshold)
        s.net = kitnet_from_arrays(arrays, device=where)
        outs[where] = s.process_stream(small, chunk=512)
    (i_g, s_g, a_g), (i_c, s_c, a_c) = outs["cuda"], outs["cpu"]
    if not np.array_equal(i_g, i_c):
        raise RuntimeError("card and CPU record indices differ")
    score_err = float(np.abs(s_g - s_c).max())
    if not score_err <= SCORE_TOL:
        raise RuntimeError(f"card vs CPU scores differ by {score_err}")
    near = np.abs(s_c - svc.threshold) <= SCORE_TOL
    if not np.array_equal(a_g[~near], a_c[~near]):
        raise RuntimeError("card and CPU alarms differ away from the threshold")
    emit({"phase": "reference", "records": int(len(i_g)),
          "max_score_err": score_err, "alarms": int(a_g.sum())}, log)

    # ---- 6b. the sketch service on the card against the CPU ----
    phase_sketch_reference(kitnet_to_arrays(sketch_svc.net), sketch_svc.threshold, log)

    # ---- 6c. switch arithmetic, the scan, bucketed and sharded backends,
    # the engine, the evaluation protocol ----
    switch_tr, switch_cpu = phase_switch(dev, log)
    phase_scan(dev, pk, log)
    phase_scan_main(data, main, main_trace, log)
    part = phase_partition(dev, data, pk, main, main_trace, switch_tr, switch_cpu, log)
    engine = phase_engine(dev, data, svc, sketch_svc, log)
    phase_mesh(dev, data, svc, sketch_svc, part, switch_tr, log)
    del part
    phase_eval(data, net, log)

    # ---- 7. LM serving of gemma2-2b at full width, traced, against plain ----
    flash["launches"], long_prompt_s = phase_lm_main(log)
    phase_lm_trace(long_prompt_s, log)
    phase_lm_reference(log)

    # ---- 7b. the MoE, hybrid, xLSTM, VLM and audio families ----
    family_launches, flash["family_shapes"] = phase_lm_families(log)
    flash["launches"] += family_launches

    # ---- 8. LM training of gemma2-2b at full width, card against CPU, resume ----
    phase_train_main(log)
    phase_train_reference(log)
    phase_train_resume(log)

    # ---- 8b. training of the MoE, hybrid, xLSTM, VLM and audio families ----
    phase_train_families(log)
    phase_train_families_reference(log)

    # ---- 9. the LM stack placed over a mesh, the dry run on the meta device ----
    flash["launches"] += phase_lm_mesh(log)
    phase_dryrun(log)

    # ---- report ----
    fc["launches"] = launches["fc_full"]
    ens["launches"] = launches["kitnet_ae"]
    score["launches"] = launches["kitnet_score"]
    sk["launches"] = sketch_launches["sketch_update"]
    fc["tenant_axis"] = {"lanes": 3, "batched_ms": engine["fc_tenants"]["batched"]["ms"],
                         "three_single_ms": engine["fc_tenants"]["three_single"]["three_ms"],
                         "engine_launches": engine["run"]["launches"]["fc_full"]}
    single["launches"] = single_launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("bf16", "chain_floor_ms", "computes", "tenant_axis", "family_shapes")
    table = {"kernels": [{**{key: kern[key] for key in keys},
                          **{key: kern[key] for key in extra if key in kern}}
                         for kern in (fc, ens, score, sk, single, flash)]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"phases": log, **table, "card": smi}, indent=1))
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
