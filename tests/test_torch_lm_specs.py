"""PyTorch port, the LM stack's placement specs held exactly against the
JAX package on the CPU: ``mesh_rules.make_rules`` and
``distributed/params.py``'s ``param_specs``, ``opt_specs`` (AdamW and
Adafactor states, with and without ZeRO-1), ``batch_specs`` and
``cache_specs`` for all ten archs at full width.  Both sides read shapes
only: JAX's trees come from ``jax.eval_shape``, the port's from
``build_model(cfg, device="meta")`` (kimi-k2's 1T parameters are never
allocated).  Specs are compared leaf by leaf by key path, as tuples; a spec
of the port equals JAX's only if every entry does (JAX keeps a tuple of
one axis as the axis, and so does the port's ``P``)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_arch as jax_get_arch
from repro.distributed.mesh_rules import make_rules as jax_make_rules
from repro.distributed.params import batch_specs as jax_batch_specs
from repro.distributed.params import cache_specs as jax_cache_specs
from repro.distributed.params import opt_specs as jax_opt_specs
from repro.distributed.params import param_specs as jax_param_specs
from repro.distributed.sharding import AxisRules as JaxAxisRules
from repro.models import build_model as jax_build_model
from repro.training import optim as jax_optim
from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, TrainConfig, get_arch
from repro_torch.distributed.mesh_rules import make_rules
from repro_torch.distributed.params import (batch_specs, cache_specs, opt_specs,
                                            param_specs)
from repro_torch.distributed.sharding import AxisRules, P
from repro_torch.models import build_model
from repro_torch.models.transformer import params_tree
from repro_torch.training.optim import make_optimizer

torch.set_num_threads(1)
MESH = {"data": 16, "model": 16}
CACHE_B, CACHE_S = 2, 64


def _key(k):
    return getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))


def _jax_specs(t) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_specs(t) -> dict:
    return {path: tuple(s) for path, s in tree.flatten_with_paths(t)}


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    """(JAX's params shapes, the port's meta params tree)."""
    jm = jax_build_model(jax_get_arch(arch))
    jp = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    tp = params_tree(build_model(get_arch(arch), device="meta").init_params(0))
    return jm, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_match_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for multi_pod in (False, True):
        assert make_rules(cfg, multi_pod=multi_pod) == jax_make_rules(jcfg, multi_pod=multi_pod)
        for name, shape in SHAPES.items():
            for kw in ({}, {"model_size": 4, "dp_size": 2}):
                want = jax_make_rules(jcfg, JAX_SHAPES[name], multi_pod=multi_pod, **kw)
                assert make_rules(cfg, shape, multi_pod=multi_pod, **kw) == want, (name, kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_from_shapes(arch):
    _, jp, tp = _shapes(arch)
    assert all(t.device.type == "meta" for t in tree.leaves(tp))
    assert {p: tuple(t.shape) for p, t in tree.flatten_with_paths(tp)} == {
        tuple(_key(k) for k in path): tuple(x.shape)
        for path, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    rules_d = make_rules(get_arch(arch), SHAPES["train_4k"])
    jrules = JaxAxisRules(jax_make_rules(jax_get_arch(arch), JAX_SHAPES["train_4k"]))
    for fsdp in (0, 16):
        for serve_ff in (0, 16):
            got = param_specs(tp, get_arch(arch), AxisRules(rules_d), 16, fsdp, serve_ff)
            want = jax_param_specs(jp, jax_get_arch(arch), jrules, 16, fsdp, serve_ff)
            assert all(isinstance(s, P) for s in tree.leaves(got))
            assert _port_specs(got) == _jax_specs(want), (fsdp, serve_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_jax(arch):
    """AdamW's {m, v, step} and Adafactor's {vr, vc, step} (the factored
    moments inherit the parameter's spec minus a dimension), with ZeRO-1 on
    and off, and with the opt rule unbound (a batch the DP size does not
    divide)."""
    _, jp, tp = _shapes(arch)
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for shape in ("train_4k", "long_500k"):
        rules = AxisRules(make_rules(cfg, SHAPES[shape]))
        jrules = JaxAxisRules(jax_make_rules(jcfg, JAX_SHAPES[shape]))
        ps = param_specs(tp, cfg, rules, 16, 16 if cfg.is_moe else 0)
        jps = jax_param_specs(jp, jcfg, jrules, 16, 16 if cfg.is_moe else 0)
        for opt in ("adamw", "adafactor"):
            init, _ = make_optimizer(TrainConfig(optimizer=opt))
            jinit, _ = jax_optim.make_optimizer(JaxTrainConfig(optimizer=opt))
            st = init(tp)
            jst = jax.eval_shape(jinit, jp)
            for zero1 in (False, True):
                got = opt_specs(st, ps, cfg, rules, MESH, zero1)
                want = jax_opt_specs(jst, jps, jcfg, jrules, MESH, zero1)
                assert _port_specs(got) == _jax_specs(want), (shape, opt, zero1)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    jm, _, _ = _shapes(arch)
    for name in SHAPES:
        rules = AxisRules(make_rules(cfg, SHAPES[name]))
        jrules = JaxAxisRules(jax_make_rules(jcfg, JAX_SHAPES[name]))
        assert _port_specs(batch_specs(cfg, SHAPES[name], rules)) == _jax_specs(
            jax_batch_specs(jcfg, JAX_SHAPES[name], jrules))
        if cfg.is_encoder:
            continue
        cache = build_model(cfg, device="meta").init_cache(CACHE_B, CACHE_S)
        jcache = jax.eval_shape(lambda: jm.init_cache(CACHE_B, CACHE_S))
        for long_context in (False, True):
            got = cache_specs(cache, cfg, rules, long_context)
            want = jax_cache_specs(jcache, jcfg, jrules, long_context)
            assert _port_specs(got) == _jax_specs(want), (name, long_context)


def test_meta_params_allocate_nothing_and_match_real_shapes():
    """The meta tree is the real tree's shapes and dtypes, and a meta model's
    init draws nothing (kimi-k2 at full width is 1.03e12 parameters)."""
    from repro_torch.configs import reduced
    cfg = reduced(get_arch("kimi-k2-1t-a32b"))
    meta = params_tree(build_model(cfg, device="meta").init_params(0, dtype=torch.bfloat16))
    real = params_tree(build_model(cfg, device="cpu").init_params(0, dtype=torch.bfloat16))
    assert [(p, tuple(t.shape), t.dtype) for p, t in tree.flatten_with_paths(meta)] == [
        (p, tuple(t.shape), t.dtype) for p, t in tree.flatten_with_paths(real)]
    full = params_tree(build_model(get_arch("kimi-k2-1t-a32b"), device="meta").init_params(0))
    n = sum(int(np.prod(t.shape)) for t in tree.leaves(full))
    assert n > 1e12 and all(t.device.type == "meta" for t in tree.leaves(full))
