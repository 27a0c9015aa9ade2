"""PyTorch port: the dry run on the meta device (``launch/specs.py``,
``launch/dryrun.py``) against the JAX package's, on the CPU.

  * bytes a place: ``arg_bytes_per_device``, ``params``, ``active_params``,
    ``train_posture`` and the skip reasons equal JAX's exactly, for every
    arch at train_4k and decode_32k on the 16x16 mesh and two 2x16x16 cells.
    JAX's side is its own ``input_specs`` + ``param_specs``/``opt_specs``/
    ``batch_specs``/``cache_specs`` + ``dryrun._arg_bytes``, as its
    ``_lower_once`` builds them, with no compile: one subprocess on 512
    forced host devices (its dry run's);
  * FLOPs: a reduced dense cell's placed train step, every replica run: the
    places' FLOPs sum to the one-device step's at microbatches = the data
    size exactly (``torch.utils.flop_counter``; the count of
    ``FlopCounterMode`` around the placed step too); the forward's FLOPs
    equal a count written out from the config; JAX's compiled
    ``cost_analysis()["flops"]`` of the same forward is printed beside it;
  * memory: a reduced cell's peaks a place are positive, the largest at
    least the place's share of the arguments; the replicas counted from one
    equal the replicas all run (FLOPs, bytes moved, peaks);
  * ``run_cells`` on a reduced cell writes its JSON, and on a skipped cell
    ``__skip.json`` with ``skip_reason``'s text;
  * JAX's variants: ``serve_opt`` and ``fsdp_experts_only`` give
    ``arg_bytes_per_device`` equal to JAX's (``_lower_once``'s specs) on
    four production MoE cells; on reduced MoE cells each of the three runs
    its step: ``moe_local`` through ``moe_ffn_local`` with the record of the
    default run (the placed steps' one MoE layout), ``serve_opt`` and
    ``fsdp_experts_only`` with the default run's FLOPs, other bytes a place
    and fewer bytes of FSDP blocks gathered;
  * depth: a deep cell of alike stacked layers (``extrapolation_depths``)
    run at three depths and continued to its own equals its full-depth
    run; ``PlaceCount``'s plain results give the kernels' record.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced, skip_reason
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from repro_torch.models import build_model
from repro_torch.training import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ([(a, s, False) for a in ARCHS for s in ("train_4k", "decode_32k")]
         + [("kimi-k2-1t-a32b", "decode_32k", True), ("qwen2-vl-72b", "train_4k", True)])
FLAG_CELLS = [("kimi-k2-1t-a32b", "decode_32k", True, "serve_opt"),
              ("kimi-k2-1t-a32b", "decode_32k", True, "fsdp_experts_only"),
              ("phi3.5-moe-42b-a6.6b", "decode_32k", False, "serve_opt"),
              ("phi3.5-moe-42b-a6.6b", "train_4k", False, "fsdp_experts_only")]
MOE = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    """JAX's record keys of every cell in CELLS, without a compile."""
    out = tmp_path_factory.mktemp("jax_dryrun") / "cells.json"
    code = textwrap.dedent(f"""
        import json
        from repro.launch import dryrun as D          # forces 512 host devices first
        import numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.configs import SHAPES, get_arch, skip_reason
        from repro.distributed.mesh_rules import make_rules
        from repro.distributed.params import batch_specs, cache_specs, opt_specs, param_specs
        from repro.distributed.sharding import AxisRules, use_rules
        from repro.launch.mesh import make_production_mesh, mesh_shape_dict
        from repro.launch.specs import arch_for_cell, input_specs
        res = {{}}
        cells = [(*c, "") for c in {CELLS!r}] + {FLAG_CELLS!r}
        for arch, shape_name, mp, flag in cells:
            shape = SHAPES[shape_name]
            key = f"{{arch}}|{{shape_name}}|{{mp}}" + (f"|{{flag}}" if flag else "")
            reason = skip_reason(get_arch(arch), shape)
            if reason:
                res[key] = {{"skipped": reason}}
                continue
            cfg = arch_for_cell(arch, shape)
            mesh = make_production_mesh(multi_pod=mp)
            md = mesh_shape_dict(mesh)
            dp = int(np.prod([v for k, v in md.items() if k != "model"]))
            rules_d = make_rules(cfg, shape, multi_pod=mp, model_size=md.get("model", 1),
                                 dp_size=dp)
            if flag == "fsdp_experts_only":          # as _lower_once
                rules_d["fsdp2"] = None
            rules = AxisRules(rules_d)
            ms, fsdp = D._spec_tree_for_cell(shape.kind, cfg, shape, rules, mesh, None)
            serve_ff = 0
            if flag == "serve_opt" and shape.kind != "train":
                fsdp, serve_ff = 0, dp
            with use_rules(rules_d):
                step, args, cfg, tc = input_specs(arch, shape_name, cfg)
                if shape.kind == "train":
                    state, batch = args
                    ps = param_specs(state["params"], cfg, rules, ms, fsdp)
                    ss = {{"params": ps, "opt": opt_specs(state["opt"], ps, cfg, rules, md,
                                                          tc.zero1), "step": P()}}
                    if "ef_err" in state:
                        ss["ef_err"] = ps
                    sh = (ss, batch_specs(cfg, shape, rules))
                else:
                    params, tokens, cache = args
                    sh = (param_specs(params, cfg, rules, ms, fsdp, serve_ff),
                          rules.spec(("batch", None)),
                          cache_specs(cache, cfg, rules, long_context=shape.name == "long_500k"))
            res[key] = {{"params": cfg.param_count(), "active_params": cfg.active_param_count(),
                        "train_posture": {{"optimizer": tc.optimizer,
                                          "param_dtype": tc.param_dtype, "remat": tc.remat,
                                          "zero1": tc.zero1, "fsdp": fsdp > 1}}
                        if shape.kind == "train" else None,
                        "arg_bytes_per_device": D._arg_bytes(args, sh, md)}}
        open({str(out)!r}, "w").write(json.dumps(res))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


def _port_cell(arch, shape_name, mp, **flags):
    reason = skip_reason(get_arch(arch), SHAPES[shape_name])
    if reason:
        return {"skipped": reason}
    mesh, rules_d, shape, cfg, tc, args, in_sh, fsdp = dryrun.cell_specs(arch, shape_name, mp,
                                                                         **flags)
    return {"params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "train_posture": {"optimizer": tc.optimizer, "param_dtype": tc.param_dtype,
                              "remat": tc.remat, "zero1": tc.zero1, "fsdp": fsdp > 1}
            if shape.kind == "train" else None,
            "arg_bytes_per_device": dryrun._arg_bytes(args, in_sh, dict(mesh.shape))}


@pytest.mark.parametrize("arch,shape,mp", CELLS,
                         ids=[f"{a}-{s}-{'mp' if m else 'sp'}" for a, s, m in CELLS])
def test_bytes_a_place_equal_jax(jax_cells, arch, shape, mp):
    assert _port_cell(arch, shape, mp) == jax_cells[f"{arch}|{shape}|{mp}"]


@pytest.mark.parametrize("arch,shape,mp,flag", FLAG_CELLS,
                         ids=[f"{a}-{s}-{'mp' if m else 'sp'}-{f}" for a, s, m, f in FLAG_CELLS])
def test_variant_bytes_a_place_equal_jax(jax_cells, arch, shape, mp, flag):
    got = _port_cell(arch, shape, mp, **{flag: True})
    assert got == jax_cells[f"{arch}|{shape}|{mp}|{flag}"]
    assert got["arg_bytes_per_device"] != _port_cell(arch, shape, mp)["arg_bytes_per_device"]


# ---------------------------------------------------------------------------
# FLOPs, memory, bytes moved
# ---------------------------------------------------------------------------
def _dense_forward_flops(cfg, B, S) -> int:
    """The forward's matrix products and attention (4 B H S^2 hd: every
    (query, key) pair, as the flop counter counts attention) of a dense
    config, written out."""
    T, d, hd, H, K = B * S, cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mlp = (3 if cfg.gated_mlp else 2) * 2 * T * d * cfg.d_ff
    layer = 2 * T * d * (H + 2 * K) * hd + 4 * B * H * S * S * hd + 2 * T * H * hd * d + mlp
    return cfg.n_layers * layer + 2 * T * d * cfg.vocab


def test_flops_split_sum_to_one_device():
    rec = dryrun.lower_cell("deepseek-7b", "train_4k", False, replicas=None, reduce=True)
    assert rec["replicas"] == {"all": 4, "run": 4}
    assert rec["flops"]["total"] == sum(rec["flops"]["per_place"]) == rec["flops"]["counted_run"]
    _, shape, mesh = dryrun.reduced_cell("deepseek-7b", "train_4k", False)
    _, (state, batch), cfg, tc = input_specs("deepseek-7b", shape, reduced(get_arch("deepseek-7b")))
    one = make_train_step(build_model(cfg, device="meta"), dataclasses.replace(tc, microbatches=4))
    with FlopCounterMode(display=False) as fc:
        one(state, batch)
    assert rec["flops"]["total"] == fc.get_total_flops()
    assert min(rec["flops"]["per_place"]) > 0        # every place computes its share
    # the forward against the count from the config, JAX's compiled count beside it
    B, S = shape.global_batch, shape.seq_len
    params = build_model(cfg, device="meta").init_params(0)
    with FlopCounterMode(display=False) as fc:
        build_model(cfg, device="meta").forward(params, {"tokens": batch["tokens"]})
    assert fc.get_total_flops() == _dense_forward_flops(cfg, B, S)
    jm = jax_build_model(jax_reduced(jax_get_arch("deepseek-7b")))
    jp = jax.eval_shape(lambda k: jm.init_params(k), jax.random.PRNGKey(0))
    cost = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0]).lower(
        jp, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    print(f"reduced deepseek-7b forward B={B} S={S}: port {fc.get_total_flops()}, "
          f"written out {_dense_forward_flops(cfg, B, S)}, JAX compiled {cost['flops']:.0f}")


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "train_4k"),
                                        ("qwen2-vl-72b", "prefill_32k"),
                                        ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                                        ("qwen2-vl-72b", "train_4k"),
                                        ("kimi-k2-1t-a32b", "train_4k")])
def test_one_replica_counts_as_all(arch, shape):
    """A reduced cell with one replica run and the rest counted from it,
    against every replica run: FLOPs a place and in total, the peak a place
    and the bytes moved by kind (but the hand-overs to place 0: replica 0's
    own are none, so the counted ones exceed by one replica's).  The reduce
    of the gradients to their owners is counted a replica at a time: every
    replica hands the owners the same parts, so one counts as all.  The
    train cells: AdamW with remat "dots", AdamW with ZeRO-1 in bf16 under
    remat "full" (qwen2-vl-72b's posture) and Adafactor (kimi-k2's), the
    weights cut over the data places too in each."""
    one = dryrun.lower_cell(arch, shape, False, replicas=1, reduce=True)
    every = dryrun.lower_cell(arch, shape, False, replicas=None, reduce=True)
    assert one["replicas"]["run"] == 1 and every["replicas"]["run"] == 4
    assert one["flops"]["per_place"] == every["flops"]["per_place"]
    assert one["memory"]["peak_bytes_per_place"][1:] == every["memory"]["peak_bytes_per_place"][1:]
    assert every["memory"]["peak_bytes_largest_place"] > 0
    assert every["memory"]["peak_bytes_one_device"] >= every["memory"]["peak_bytes_largest_place"]
    sink = {"metrics", "logits"}
    for k, v in every["transfer_bytes"].items():
        if k not in sink and k != "total":
            assert one["transfer_bytes"][k] == v, k


def test_run_cells_writes_records(tmp_path):
    out = dryrun.run_cells(["gemma2-2b", "hubert-xlarge"], ["decode_32k"], [False], tmp_path,
                           reduce=True)
    rec = json.loads((tmp_path / "gemma2-2b__decode_32k__singlepod.json").read_text())
    assert out and rec["arch"] == "gemma2-2b" and rec["mesh"] == "data=4xmodel=2"
    for key in ("n_devices", "params", "active_params", "train_posture",
                "arg_bytes_per_device", "memory", "flops", "transfer_bytes", "transfers",
                "cost_lowering"):
        assert key in rec, key
    assert rec["transfer_bytes"]["total"] > 0 and rec["flops"]["total"] > 0
    skip = json.loads((tmp_path / "hubert-xlarge__decode_32k__skip.json").read_text())
    assert skip["skipped"] == skip_reason(get_arch("hubert-xlarge"), SHAPES["decode_32k"])


def test_moe_local_runs_moe_ffn_local(monkeypatch):
    """Reduced phi3.5-moe train_4k: the experts are cut over the model axis,
    and with ``moe_local`` or without, the placed step runs them through
    ``moe_ffn_local`` with the same record."""
    from repro_torch.models import moe
    calls = []
    real = moe.moe_ffn_local
    monkeypatch.setattr(moe, "moe_ffn_local", lambda *a: calls.append(1) or real(*a))
    base = dryrun.lower_cell(MOE, "train_4k", False, reduce=True)
    n_default = len(calls)
    rec = dryrun.lower_cell(MOE, "train_4k", False, moe_local=True, reduce=True)
    assert n_default > 0 and len(calls) == 2 * n_default
    assert rec["moe_dispatch"] == base["moe_dispatch"] == "local"
    for key in ("arg_bytes_per_device", "memory", "flops", "transfer_bytes", "transfers"):
        assert rec[key] == base[key], key


@pytest.mark.parametrize("flag,shape", [("serve_opt", "decode_32k"),
                                        ("fsdp_experts_only", "train_4k")])
def test_variant_runs_the_same_compute_placed_otherwise(flag, shape):
    """Reduced phi3.5-moe: ``serve_opt`` (no FSDP; the expert ff cut over
    the data axes) and ``fsdp_experts_only`` (the dense leaves whole in
    each model place) place the weights otherwise and compute the same:
    the default run's FLOPs, other bytes a place, fewer bytes of FSDP
    blocks gathered."""
    base = dryrun.lower_cell(MOE, shape, False, reduce=True)
    rec = dryrun.lower_cell(MOE, shape, False, reduce=True, **{flag: True})
    assert rec["flops"]["total"] == base["flops"]["total"] > 0
    assert rec["arg_bytes_per_device"] != base["arg_bytes_per_device"]
    assert 0 < rec["transfer_bytes"]["fsdp_gather"] < base["transfer_bytes"]["fsdp_gather"]


@pytest.mark.parametrize("arch,shape,mp", [("qwen2-vl-72b", "train_4k", False),
                                           ("qwen2-vl-72b", "prefill_32k", False),
                                           ("kimi-k2-1t-a32b", "decode_32k", True)])
def test_extrapolated_depth_equals_full_depth(monkeypatch, arch, shape, mp):
    """A reduced cell at 8 layers, run at 2, 3 and 4 layers and continued
    to 8 (``extrapolation_depths``), gives the record of its run at all 8
    layers: each place's peak and FLOPs, the bytes and hand-overs by kind.
    A cell no deeper than 4 layers runs at its full depth, and counts that
    do not go the same step from depth to depth raise."""
    real = dryrun.reduced
    monkeypatch.setattr(dryrun, "reduced", lambda cfg: dataclasses.replace(real(cfg), n_layers=8))
    ext = dryrun.lower_cell(arch, shape, mp, reduce=True)
    with monkeypatch.context() as m:
        m.setattr(dryrun, "extrapolation_depths", lambda cfg: None)
        full = dryrun.lower_cell(arch, shape, mp, reduce=True)
    assert full["cost_lowering"].startswith("meta_full_depth")
    assert ext["cost_lowering"].startswith("meta_extrapolated(depths=[2, 3, 4],L=8)")
    for key in ("memory", "flops", "transfer_bytes", "transfers", "arg_bytes_per_device"):
        assert ext[key] == full[key], key
    monkeypatch.setattr(dryrun, "reduced", lambda cfg: dataclasses.replace(real(cfg), n_layers=4))
    assert dryrun.lower_cell(arch, shape, mp, reduce=True)["cost_lowering"].startswith(
        "meta_full_depth")
    run = {"flops": [1], "peak": [1], "one_peak": None, "counted": None, "bytes": {},
           "times": {}, "homes": 1, "run": 1}
    runs = [dict(run, peak=[v]) for v in (10, 20, 31)]
    with pytest.raises(ValueError, match="not linear"):
        dryrun._extrapolated(runs, (2, 3, 4), 8)


def test_extrapolation_depths_of_the_production_archs():
    """Which cells run at three depths and are continued: every stacked
    family at 2p, 3p and 4p of its layer period (gemma2-2b's alternating
    windows: 2), the hybrid and the ssm family at their full depth."""
    want = {"gemma2-2b": (4, 6, 8), "zamba2-2.7b": None, "xlstm-125m": None}
    for arch in ARCHS:
        assert dryrun.extrapolation_depths(get_arch(arch)) == want.get(arch, (2, 3, 4)), arch


@pytest.mark.parametrize("arch,shape", [("qwen2-vl-72b", "train_4k"),
                                        ("kimi-k2-1t-a32b", "train_4k"),
                                        ("zamba2-2.7b", "decode_32k")])
def test_plain_pointwise_results_match_the_kernels(monkeypatch, arch, shape):
    """``PlaceCount`` makes plain pointwise and ``cat`` results directly
    (``_plain_result``, ``_plain_cat``): the record is the one the meta
    kernels' own results give, memory, FLOPs and bytes alike, and the ops
    it made that way are many."""
    made = []
    real = dryrun._plain_result

    def plain_result(*a):
        out = real(*a)
        made.append(out is not None)
        return out

    monkeypatch.setattr(dryrun, "_plain_result", plain_result)
    fast = dryrun.lower_cell(arch, shape, False, reduce=True)
    monkeypatch.setattr(dryrun, "_plain_result", lambda *a: None)
    monkeypatch.setattr(dryrun, "_plain_cat", lambda *a: None)
    slow = dryrun.lower_cell(arch, shape, False, reduce=True)
    assert sum(made) > 100
    for key in ("memory", "flops", "transfer_bytes", "transfers"):
        assert fast[key] == slow[key], key
