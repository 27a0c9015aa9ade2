"""PyTorch port, the training options on the families beyond dense, held
against the JAX package's train step on the CPU at the reduced configs:
bfloat16 compute on the hybrid (zamba2), microbatches on the MoE
(phi3.5-moe), the three remat policies on the hybrid (whose rematted body
holds the shared block's application, as JAX's scan body does), Adafactor
and int8 error feedback on the xLSTM's list of unstacked leaves, the
compute-dtype cast of its float32 gate leaves, and the fault loop resuming
a hybrid and an xLSTM state.

The tolerances, with the errors measured on this CPU (``python
tests/test_torch_train_families_options.py`` prints them).  bfloat16,
Adafactor and int8 error feedback take each of three steps from JAX's state
before it, so a step is held to its own rounding, not to the sign flips the
earlier steps carried (chained, they compound: the xLSTM's int8 share past
the envelope reached 8.6e-4 of its 1e-3 at step 3, and qwen2-vl's bfloat16
loss at step 2 read 7.7e-5 on 8 threads and 1.5e-4 on one):
  * bfloat16 compute, tests/test_torch_training.py's envelope, on qwen2-vl
    (the dense stack with M-RoPE): loss 1e-4 relative (6.7e-5), grad norm
    5e-3 (8.1e-4), every parameter within 2 * lr of JAX's (an update whose
    sign flips), at most 5% past 1e-4 (0.4%).  The other families from the
    same states: loss up to 1.0e-4 (xLSTM, zamba2), 2.5e-4 (hubert) and
    5.1e-4 (phi3.5-moe): JAX rounds every bfloat16 elementwise op where
    PyTorch computes silu and gelu in float32 and rounds once (about 40% of
    their outputs differ by an ulp), and an ulp moves a near-tied token to
    another expert;
  * microbatches=2 (phi3.5-moe), chained: each microbatch's loss holds its
    aux and the reported aux is 0, as in JAX; loss and grad norm 1e-5
    relative (1.4e-7, 2.6e-7), parameters in the float32 envelope (share
    past atol 1e-5 + rtol 1e-5 2.8e-6 of at most 1e-4);
  * remat none/dots/full on the hybrid: loss and gradients 1e-5 (equal
    here), the JAX package's own bound (tests/test_training.py);
  * Adafactor on the xLSTM: loss and grad norm 1e-5 (2.1e-7, 8.2e-7),
    parameters in the float32 envelope (3.1e-6; none past it), its state
    within 2e-5 (tests/test_torch_training.py's Adafactor bound: its
    means over a leaf sum in another order);
  * int8 error feedback on the xLSTM, tests/test_torch_training.py's
    envelope: loss 1e-5 (2.9e-7); a gradient within an ulp of a rounding
    boundary quantises a step apart, so the grad norm 1e-4 (8.9e-6), every
    parameter within 2 * lr (5.0e-4 of 1e-3), at most 0.1% past atol 1e-5
    + rtol 1e-5 (0.0013%);
  * resume after injected failures: rtol 1e-5, atol 1e-6 (the JAX
    package's, tests/test_fault_tolerance.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.train_step import cast_tree as jax_cast_tree
from repro_torch import tree
from repro_torch.configs import TrainConfig
from repro_torch.interop import train_state_from_arrays, train_state_to_arrays
from repro_torch.models.transformer import params_tree
from repro_torch.training import (CheckpointManager, init_train_state,
                                  make_train_step, use_remat)
from repro_torch.training.fault import FailureInjector, resilient_loop
from repro_torch.training.train_step import cast_tree
from test_torch_train_families import (ARCHS, PHI, QWEN, XLSTM, ZAMBA, _batches, _pair,
                                       jax_run, port_steps)
from test_torch_training import (ADAFACTOR_TOL, BF16_GN_TOL, BF16_LOSS_TOL,
                                 BF16_SHARE, EF_GN_TOL, EF_SHARE, F32_SHARE,
                                 F32_TOL, _CountOps, _flat, _rel, _tbatch)

BF16_KW = dict(compute_dtype="bfloat16")


def step_errors(arch, **kw):
    """Each of the three steps from JAX's state before it (a step's own
    arithmetic, not what the earlier steps carried): loss and grad norm
    relative errors, the parameters' max error, their share past atol
    1e-5 + rtol 1e-5 and past 1e-4, and 2 * lr; with the port's last state
    and JAX's."""
    tc, m, batches, states, metrics, _ = jax_run(arch, **kw)
    step = make_train_step(m, tc)
    out = []
    for i, b in enumerate(batches):
        state = train_state_from_arrays(m.cfg, tc, states[i], device="cpu")
        state, met = step(state, _tbatch(b))
        want = _flat(states[i + 1]["params"])
        d = np.abs(_flat(train_state_to_arrays(state["params"])) - want)
        out.append({"loss": _rel(met["loss"], metrics[i]["loss"]),
                    "grad_norm": _rel(met["grad_norm"], metrics[i]["grad_norm"]),
                    "max": float(d.max()),
                    "share_f32": float((d > F32_TOL + F32_TOL * np.abs(want)).mean()),
                    "share_1e-4": float((d > 1e-4).mean()), "two_lr": 2 * metrics[i]["lr"]})
    return out, state, states[-1]


def test_bf16_steps_match_jax():
    for e in step_errors(QWEN, **BF16_KW)[0]:
        assert e["loss"] <= BF16_LOSS_TOL and e["grad_norm"] <= BF16_GN_TOL, e
        assert e["max"] <= e["two_lr"] and e["share_1e-4"] <= BF16_SHARE, e


def test_moe_microbatches_match_jax():
    """Each microbatch's loss holds its aux; the reported aux is 0 and ce
    the loss, as in JAX; the steps in the float32 envelope."""
    errs, _, met = port_steps(PHI, microbatches=2)
    _, _, _, _, metrics, _ = jax_run(PHI, microbatches=2)
    assert float(met["aux"]) == metrics[-1]["aux"] == 0.0
    assert float(met["ce"]) == float(met["loss"])
    for e in errs:
        assert e["loss"] <= F32_TOL and e["grad_norm"] <= F32_TOL, e
        assert e["params"][0] <= e["two_sum_lr"] and e["params"][1] <= F32_SHARE, e
    # the aux counts: one microbatch's loss above its ce by aux_weight * aux
    _, m = _pair(PHI)
    half = {k: v[:4] for k, v in _tbatch(_batches(m.cfg, 1)[0]).items()}
    loss, parts = m.loss(params_tree(m.init_params(0)), half)
    assert float(parts["aux"]) > 0
    assert abs(float(loss) - float(parts["ce"] + 0.01 * parts["aux"])) < 1e-6


def _remat_runs():
    """The hybrid's loss and gradients under each policy, and the products
    and rsqrts its backward runs (what each policy recomputes)."""
    _, m = _pair(ZAMBA)
    b = _tbatch(_batches(m.cfg, 1, seed=3, seq=20)[0])
    out, ops = {}, {}
    for remat in ("none", "dots", "full"):
        tc = TrainConfig(remat=remat, compute_dtype="float32")
        state = init_train_state(m, tc, 0)
        out[remat] = make_train_step(m, tc).compute_grads(state["params"], b)
        leaves = [p.requires_grad_(True) for p in tree.leaves(state["params"])]
        with use_remat(remat):
            loss, _ = m.loss(tree.unflatten(state["params"], leaves), b)
        with _CountOps() as count:
            torch.autograd.grad(loss, leaves)
        aten = torch.ops.aten
        ops[remat] = (count.n[aten.mm.default] + count.n[aten.bmm.default],
                      count.n[aten.rsqrt.default])
    return out, ops


def test_hybrid_remat_policies_agree():
    """Loss and gradients equal under none/dots/full; the backward
    recomputes no forward op under none, the layers' norms (the shared
    block's among them) but no product under dots, the products too under
    full."""
    out, ops = _remat_runs()
    for remat in ("dots", "full"):
        assert abs(float(out["none"][0]) - float(out[remat][0])) <= F32_TOL
        for g, w in zip(tree.leaves(out[remat][2]), tree.leaves(out["none"][2])):
            torch.testing.assert_close(g, w, rtol=F32_TOL, atol=1e-7)
    # rsqrt: each layer's norm, the gated norm, and the shared block's two
    _, m = _pair(ZAMBA)
    n_norms = 2 * m.cfg.n_layers + 2 * (m.cfg.n_layers // m.cfg.attn_every)
    assert ops["none"][1] == 0 and ops["dots"][1] == ops["full"][1] == n_norms, ops
    assert ops["none"][0] == ops["dots"][0] < ops["full"][0], ops


@pytest.mark.parametrize("kw", [dict(optimizer="adafactor"),
                                dict(grad_compression="int8_ef")])
def test_xlstm_optimizers_match_jax(kw):
    errs, state, want = step_errors(XLSTM, **kw)
    ef = "grad_compression" in kw
    for e in errs:
        assert e["loss"] <= F32_TOL, e
        assert e["grad_norm"] <= (EF_GN_TOL if ef else F32_TOL), e
        assert e["max"] <= e["two_lr"], e
        assert e["share_f32"] <= (EF_SHARE if ef else F32_SHARE), e
    got = train_state_to_arrays(state)
    assert tree.key_paths(got) == tree.key_paths(want)
    if not ef:
        # an unstacked 2-D leaf: row and column means over the matrix itself;
        # a 1-D float32 gate leaf: unfactored, its column state (1,)
        wq = state["opt"]["vr"]["blocks"][0]["cell"]["wq"]
        assert tuple(wq.shape) == (state["params"]["blocks"][0]["cell"]["wq"].shape[0],)
        assert tuple(state["opt"]["vc"]["blocks"][0]["cell"]["b_if"].shape) == (1,)
        for a, b in zip(tree.leaves(got["opt"]), jax.tree_util.tree_leaves(want["opt"])):
            np.testing.assert_allclose(a, b, rtol=ADAFACTOR_TOL,
                                       atol=ADAFACTOR_TOL * np.abs(b).max())


def test_cast_tree_casts_gate_leaves_as_jax():
    """The compute-dtype copy casts the xLSTM's float32 gate leaves too, as
    JAX's ``cast_tree`` does."""
    _, m = _pair(XLSTM)
    params = init_train_state(m, TrainConfig(), 0)["params"]
    assert params["blocks"][1]["cell"]["w_gates"].dtype == torch.float32
    got = cast_tree(params, torch.bfloat16)
    want = jax_cast_tree(jax.tree_util.tree_map(jnp.asarray, train_state_to_arrays(params)),
                         jnp.bfloat16)
    assert [str(t.dtype)[6:] for t in tree.leaves(got)] == \
        [str(w.dtype) for w in jax.tree_util.tree_leaves(want)] == \
        ["bfloat16"] * len(tree.leaves(got))


@pytest.mark.parametrize("arch", (XLSTM, ZAMBA))
def test_resume_after_injected_failures(arch, tmp_path):
    _, m = _pair(arch)
    tc = TrainConfig(learning_rate=1e-3)
    step = make_train_step(m, tc)
    batches = [_tbatch(b) for b in _batches(m.cfg, 8, seed=4, seq=16)]
    ref = init_train_state(m, tc, 0)
    for b in batches:
        ref, _ = step(ref, b)
    ckpt = CheckpointManager(str(tmp_path / "ft"), keep=3)
    out = resilient_loop(step, init_train_state(m, tc, 0), batches, ckpt,
                         ckpt_every=2, injector=FailureInjector(fail_at=[3, 5, 5]),
                         max_restarts=5)
    assert out["restarts"] >= 2 and out["completed"] == len(batches)
    for a, b in zip(tree.leaves(out["state"]["params"]), tree.leaves(ref["params"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    # the readings behind the tolerances in the module docstring
    for arch in ARCHS:
        for i, e in enumerate(step_errors(arch, **BF16_KW)[0]):
            print(f"bf16 {arch} step {i + 1} from JAX's state: {e}")
    for i, e in enumerate(port_steps(PHI, microbatches=2)[0]):
        print(f"mb2 phi3.5-moe step {i + 1}: {e}")
    out, ops = _remat_runs()
    for remat in ("dots", "full"):
        gerr = max(float((g - w).abs().max()) for g, w in
                   zip(tree.leaves(out[remat][2]), tree.leaves(out["none"][2])))
        print(f"remat {remat}: loss {abs(float(out['none'][0]) - float(out[remat][0])):.2e}, "
              f"grads {gerr:.2e}")
    print(f"remat backward (products, rsqrt): {ops}")
    for kw in (dict(optimizer="adafactor"), dict(grad_compression="int8_ef")):
        for i, e in enumerate(step_errors(XLSTM, **kw)[0]):
            print(f"xlstm {kw} step {i + 1} from JAX's state: {e}")
