"""PyTorch port, flash attention on the CPU: the kernel's plain version
(what the wrapper runs for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its ``ref.flash_attention_ref``, at every
shape and dtype of ``tests/test_kernels.py``; and the port's dense,
blockwise and flash paths of the model's attention against each other.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are the JAX package's: 2e-6 in float32, 2e-2 in bfloat16 for the
kernel, 2e-5 between the model's attention paths.  ``python
tests/test_torch_flash.py`` prints the measured errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (attention, blockwise_attention,
                                          dense_attention, flash_prefill)

SHAPES = [
    (1, 4, 4, 64, 64, 32),      # MHA square
    (2, 4, 2, 64, 64, 64),      # GQA
    (1, 8, 1, 96, 96, 32),      # MQA, non-multiple of block
    (2, 4, 4, 1, 128, 32),      # decode-like single query
    (1, 2, 2, 200, 72, 64),     # Sq > Sk ragged blocks
]
WINDOW_SOFTCAP = [(16, 0.0), (0, 30.0), (24, 50.0)]
KERNEL_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
PATH_TOL = 2e-5


def _qkv(seed, B, H, K, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, K, Sk, D)).astype(np.float32),
            rng.standard_normal((B, K, Sk, D)).astype(np.float32))


def _errors(qkv, dtype, **kw):
    """Max abs error of the port's plain version against the JAX kernel in
    interpret mode and against the JAX reference, in float32."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in qkv)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in qkv), **kw)
    assert got.dtype == tdt
    got = got.float().numpy()
    pallas = np.asarray(ops.flash_attention(jq, jk, jv, bq=32, bk=32,
                                            interpret=True, **kw), np.float32)
    want = np.asarray(ref.flash_attention_ref(jq, jk, jv, **kw), np.float32)
    return float(np.abs(got - pallas).max()), float(np.abs(got - want).max())


@pytest.mark.parametrize("B,H,K,Sq,Sk,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_shapes(B, H, K, Sq, Sk, D, dtype):
    qkv = _qkv(Sq + Sk, B, H, K, Sq, Sk, D)
    err_pallas, err_ref = _errors(qkv, dtype, causal=Sq == Sk)
    tol = KERNEL_TOL[dtype]
    assert err_pallas <= tol, err_pallas
    assert err_ref <= tol, err_ref


@pytest.mark.parametrize("window,softcap", WINDOW_SOFTCAP)
def test_flash_plain_matches_jax_window_softcap(window, softcap):
    qkv = _qkv(window, 1, 4, 2, 80, 80, 32)
    errs = _errors(qkv, "float32", causal=True, window=window, softcap=softcap)
    assert max(errs) <= KERNEL_TOL["float32"], errs


def _paths(window, softcap=0.0, S=64):
    cfg = reduced(get_arch("deepseek-7b"), attn_softcap=softcap)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, S, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, S, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, S, 2, 32)).astype(np.float32))
    pos = torch.arange(S)[None].expand(2, S)
    d = dense_attention(q, k, v, cfg, pos, pos, causal=True, window=window)
    bw = blockwise_attention(q, k, v, cfg, pos, pos, causal=True,
                             window=window, kv_block=16)
    fl = flash_prefill(q, k, v, cfg, causal=True, window=window)
    return d, bw, fl


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (24, 50.0)])
def test_model_attention_paths_agree(window, softcap):
    """The model's dense and blockwise paths and the flash kernel's plain
    version agree (as tests/test_kernels.py holds the JAX ones)."""
    d, bw, fl = _paths(window, softcap)
    assert float((d - bw).abs().max()) <= PATH_TOL
    assert float((d - fl).abs().max()) <= PATH_TOL


def test_attention_routes_by_length_on_cpu(monkeypatch):
    """``forward`` on the CPU takes the JAX package's routing: dense below
    BLOCKWISE_THRESHOLD tokens, blockwise from it (the threshold is lowered
    here to keep the sequence short); both give the same logits."""
    from repro_torch.models import attention as attn
    from repro_torch.models.registry import build_model
    model = build_model(reduced(get_arch("deepseek-7b")), device="cpu")
    params = model.init_params(0)
    toks = torch.arange(8)[None]
    taken = []
    for name in ("dense_attention", "blockwise_attention"):
        fn = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _fn=fn, _n=name, **kw:
                            taken.append(_n) or _fn(*a, **kw))
    dense, _, _ = model.forward(params, {"tokens": toks})
    assert set(taken) == {"dense_attention"}
    taken.clear()
    monkeypatch.setattr(attn, "BLOCKWISE_THRESHOLD", 8)
    blockwise, _, _ = model.forward(params, {"tokens": toks})
    assert set(taken) == {"blockwise_attention"}
    assert float((dense - blockwise).abs().max()) <= PATH_TOL
    q = torch.zeros(1, 8, 4, 32)
    pos = torch.arange(8)[None]
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q[:, :, :2], q[:, :, :2], model.cfg, pos, pos, impl="pallas")


def test_flash_wrapper_rejects_misfit_shapes():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="multiple of K"):
        flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError, match="takes q"):
        flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 9, 32))
    with pytest.raises(ValueError, match="at least one key"):
        flash_attention(q, torch.zeros(1, 2, 0, 32), torch.zeros(1, 2, 0, 32))


if __name__ == "__main__":
    for dtype in ("float32", "bfloat16"):
        for shape in SHAPES:
            errs = _errors(_qkv(shape[3] + shape[4], *shape), dtype,
                           causal=shape[3] == shape[4])
            print(f"{dtype} {shape}: vs pallas {errs[0]:.3g}, vs ref "
                  f"{errs[1]:.3g} (tol {KERNEL_TOL[dtype]})")
    for window, softcap in WINDOW_SOFTCAP:
        errs = _errors(_qkv(window, 1, 4, 2, 80, 80, 32), "float32",
                       causal=True, window=window, softcap=softcap)
        print(f"window {window} softcap {softcap}: vs pallas {errs[0]:.3g}, "
              f"vs ref {errs[1]:.3g} (tol 2e-6)")
    for window, softcap in [(0, 0.0), (24, 0.0), (24, 50.0)]:
        d, bw, fl = _paths(window, softcap)
        print(f"paths window {window} softcap {softcap}: dense-blockwise "
              f"{float((d - bw).abs().max()):.3g}, dense-flash "
              f"{float((d - fl).abs().max()):.3g} (tol {PATH_TOL})")
