"""PyTorch port, flash attention on the CPU: the kernel's plain version
(what the wrapper runs for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its ``ref.flash_attention_ref``, at every
shape and dtype of ``tests/test_kernels.py``; and the port's dense,
blockwise and flash paths of the model's attention against each other.

The CUDA kernel computes its products on tensor cores in split arithmetic
(bf16: P = P_hi + P_lo, two bf16 products; float32: split TF32, three
products).  A test-only emulation of that arithmetic in plain torch is held
against the reference here, so the kernel's arithmetic is checked before it
runs on a card: at the JAX test shapes to 2e-6 (float32) and 2e-2 (bf16),
at gemma2's width to 2e-5 (float32) and one bf16 ulp, 1e-5 + 2^-7 |want|.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are the JAX package's: 2e-6 in float32, 2e-2 in bfloat16 for the
kernel, 2e-5 between the model's attention paths.  ``python
tests/test_torch_flash.py`` prints the measured errors.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention import (NEG_INF, _pad_head_dim,
                                                 built_head_dim, flash_attention,
                                                 flash_attention_ref)
from repro_torch.models.attention import (attention, blockwise_attention,
                                          dense_attention, flash_prefill,
                                          is_prefill_positions)

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
GEMMA_WIDTH = (1, 8, 4, 256, 256, 256)     # gemma2's heads at a short length
ULP_RTOL, ULP_ATOL = 2.0 ** -7, 1e-5        # one bf16 ulp of the output


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


def _tf32(x: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """float32 as TF32 (10 mantissa bits): rounded to nearest, ties away
    from zero (``cvt.rna.tf32.f32``: add half of bit 13, clear 13 bits), or
    truncated, as a tensor core reads a raw float32 word."""
    bits = x.contiguous().view(torch.int32)
    if not truncate:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, kind: str):
    """x = hi + lo as the kernel splits it, each part as the tensor core
    reads it: bf16 parts (P in the bf16 kernel); TF32 parts of an A operand
    (Q, P in the float32 kernel: hi rounded to nearest, lo = x - hi handed
    over raw, so truncated); TF32 parts of a B operand (K, V: x itself
    handed over raw as hi, so truncated, and lo = x - trunc(x), truncated)."""
    if kind == "bf16":
        hi = x.to(torch.bfloat16).float()
        return hi, (x - hi).to(torch.bfloat16).float()
    hi = _tf32(x, truncate=kind == "tf32_b")
    return hi, _tf32(x - hi, truncate=True)


def _mm(a, b, eq, kind):
    """One product of the kernel: exact (bf16 S, whose bf16 products are
    exact in float32), bf16 P split into two products, or split TF32."""
    if kind == "exact":
        return torch.einsum(eq, a, b)
    if kind == "bf16":
        ah, al = _split(a, "bf16")
        return torch.einsum(eq, al, b) + torch.einsum(eq, ah, b)
    if kind == "bf16_single":
        return torch.einsum(eq, a.to(torch.bfloat16).float(), b)
    (ah, al), (bh, bl) = _split(a, "tf32"), _split(b, "tf32_b")
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def flash_split_emulation(q, k, v, *, causal=True, window=0, softcap=0.0,
                          single_pass_p=False):
    """The CUDA kernel's arithmetic in plain torch: key tiles of the
    kernel's width, the online float32 softmax, and the products in the
    kernel's split (``single_pass_p``: P rounded once to bf16 instead)."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    bk = 64 if bf16 else 16
    s_kind = "exact" if bf16 else "tf32"
    p_kind = ("bf16_single" if single_pass_p else "bf16") if bf16 else "tf32"
    qf = q.float().reshape(B, K, H // K, Sq, D)
    m = torch.full((B, K, H // K, Sq, 1), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(B, K, H // K, Sq, D)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk].float()
        s = _mm(qf, kt, "bkgqd,bktd->bkgqt", s_kind) * (1.0 / math.sqrt(D))
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones(Sq, kt.shape[2], dtype=torch.bool)
        if causal:
            ok &= qpos >= kpos
        if window > 0:
            ok &= (qpos - kpos) < window
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l, m = l * corr + p.sum(-1, keepdim=True), m_new
        o = o * corr + _mm(p, vt, "bkgqt,bktd->bkgqd", p_kind)
    return (o / l).reshape(B, H, Sq, D).to(q.dtype)


def _emulation_share(qkv, dtype, tol, rtol=0.0, **kw):
    """Max abs error of the emulation against the reference, and the largest
    share of |err| <= tol + rtol * |want| it uses."""
    x = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv]
    got = flash_split_emulation(*x, **kw)
    assert got.dtype == x[0].dtype
    want = flash_attention_ref(*x, causal=kw.get("causal", True),
                               window=kw.get("window", 0),
                               softcap=kw.get("softcap", 0.0)).float()
    err = (got.float() - want).abs()
    return float(err.max()), float((err / (tol + rtol * want.abs())).max())


@pytest.mark.parametrize("B,H,K,Sq,Sk,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_jax_shapes(B, H, K, Sq, Sk, D, dtype):
    """The kernel's split arithmetic holds the JAX package's kernel
    tolerances at its test shapes."""
    qkv = _qkv(Sq + Sk, B, H, K, Sq, Sk, D)
    err, share = _emulation_share(qkv, dtype, KERNEL_TOL[dtype],
                                  causal=Sq == Sk)
    assert share <= 1.0, err


@pytest.mark.parametrize("window,softcap", WINDOW_SOFTCAP)
def test_split_emulation_jax_window_softcap(window, softcap):
    qkv = _qkv(window, 1, 4, 2, 80, 80, 32)
    err, share = _emulation_share(qkv, "float32", KERNEL_TOL["float32"],
                                  causal=True, window=window, softcap=softcap)
    assert share <= 1.0, err


@pytest.mark.parametrize("window", [128, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_gemma_width(dtype, window):
    """At gemma2's heads (H=8, K=4, D=256, softcap 50): float32 to the
    model path's 2e-5, bf16 to one ulp of the output."""
    qkv = _qkv(window, *GEMMA_WIDTH)
    tol, rtol = (PATH_TOL, 0.0) if dtype == "float32" else (ULP_ATOL, ULP_RTOL)
    err, share = _emulation_share(qkv, dtype, tol, rtol, causal=True,
                                  window=window, softcap=50.0)
    assert share <= 1.0, err


def test_single_pass_bf16_p_misses_one_ulp():
    """Why the bf16 kernel splits P: rounded once to bf16, P V misses the
    one-ulp bound at gemma2's width many times over."""
    qkv = _qkv(0, *GEMMA_WIDTH)
    _, share = _emulation_share(qkv, "bfloat16", ULP_ATOL, ULP_RTOL,
                                causal=True, softcap=50.0, single_pass_p=True)
    assert share > 10.0, share


def test_tf32_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11, math.pi])
    hi = _tf32(x)
    assert hi[:4].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                               1.0 + 2.0 ** -9]
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert _tf32(x, truncate=True)[:4].tolist() == [1.0, -1.0, 1.0, 1.0 + 2.0 ** -10]
    for kind, rel in (("tf32", 2.0 ** -21), ("tf32_b", 2.0 ** -20)):
        hi, lo = _split(x, kind)
        assert float(((hi + lo - x).abs() / x.abs()).max()) <= rel


@pytest.mark.parametrize("B,H,K,Sq,Sk,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_shapes(B, H, K, Sq, Sk, D, dtype):
    qkv = _qkv(Sq + Sk, B, H, K, Sq, Sk, D)
    err_pallas, err_ref = _errors(qkv, dtype, causal=Sq == Sk)
    tol = KERNEL_TOL[dtype]
    assert err_pallas <= tol, err_pallas
    assert err_ref <= tol, err_ref


@pytest.mark.parametrize("D", [48, 80, 112])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_unbuilt_head_dims(D, dtype):
    """Head dims the CUDA kernel runs zero-padded (zamba2 and hubert-xlarge
    80, kimi-k2 112): the plain version against the Pallas kernel and the
    JAX reference, with GQA, window and softcap."""
    qkv = _qkv(D, 2, 4, 2, 72, 72, D)
    errs = _errors(qkv, dtype, causal=True, window=24, softcap=30.0)
    assert max(errs) <= KERNEL_TOL[dtype], errs


@pytest.mark.parametrize("D", [1, 48, 80, 112, 200])
def test_zero_padded_head_dim_keeps_the_attention(D):
    """What the wrapper hands the kernel at an unbuilt D: q, k, v zero-padded
    to the next built head dim, laid out as the inputs are; softmax attention
    on them with the scale of the true D, sliced back, equals the reference
    at D (the zeros add exact zeros to every product)."""
    Dp = built_head_dim(D)
    assert Dp in (32, 64, 128, 256) and Dp >= D
    q, k, v = (torch.from_numpy(a) for a in _qkv(D, 1, 4, 2, 40, 40, D))
    q = q.transpose(1, 2).contiguous().transpose(1, 2)     # (B, S, H, D) memory
    qp, kp, vp = (_pad_head_dim(t, Dp) for t in (q, k, v))
    assert qp.shape == (1, 4, 40, Dp) and qp.stride(3) == 1
    assert qp.stride(1) < qp.stride(2)                    # heads inside rows, as q
    assert torch.equal(qp[..., :D], q) and not qp[..., D:].any()
    kw = dict(causal=True, window=16, softcap=30.0)
    s = torch.einsum("bkgqd,bktd->bkgqt", qp.reshape(1, 2, 2, 40, Dp), kp) / math.sqrt(D)
    s = 30.0 * torch.tanh(s / 30.0)
    i = torch.arange(40)
    ok = (i[:, None] >= i[None]) & (i[:, None] - i[None] < 16)
    p = torch.softmax(torch.where(ok, s, torch.tensor(NEG_INF)), -1)
    got = torch.einsum("bkgqt,bktd->bkgqd", p, vp).reshape(1, 4, 40, Dp)
    assert not got[..., D:].any()
    want = flash_attention_ref(q, k, v, **kw)
    assert float((got[..., :D] - want).abs().max()) <= KERNEL_TOL["float32"]
    with pytest.raises(ValueError, match="head_dim 257"):
        built_head_dim(257)


def test_prefill_positions_are_arange_plus_a_constant_per_row():
    """The flash route's check: q and k positions equal, each row arange(S)
    shifted by a constant of its own (the masks sit on differences)."""
    ar = torch.arange(6)
    assert is_prefill_positions(ar[None], ar[None])
    rows = torch.stack([ar + 3, ar + 100])
    assert is_prefill_positions(rows, rows)
    assert is_prefill_positions(ar + 7, ar + 7)
    for bad in (torch.tensor([[0, 2, 1, 3, 4, 5]]), torch.tensor([[0, 1, 1, 2, 3, 4]]),
                (ar * 2)[None]):
        assert not is_prefill_positions(bad, bad)
    assert not is_prefill_positions(rows, rows + 1)
    assert not is_prefill_positions(ar[None], ar[None, :5])


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
            err, share = _emulation_share(
                _qkv(shape[3] + shape[4], *shape), dtype, KERNEL_TOL[dtype],
                causal=shape[3] == shape[4])
            print(f"split emulation {dtype} {shape}: {err:.3g} "
                  f"({share:.3f} of {KERNEL_TOL[dtype]})")
    for window in (128, 0):
        qkv = _qkv(window, *GEMMA_WIDTH)
        kw = dict(causal=True, window=window, softcap=50.0)
        err, share = _emulation_share(qkv, "float32", PATH_TOL, **kw)
        print(f"split emulation float32 {GEMMA_WIDTH} window {window}: "
              f"{err:.3g} ({share:.3f} of {PATH_TOL})")
        err, share = _emulation_share(qkv, "bfloat16", ULP_ATOL, ULP_RTOL, **kw)
        err1, share1 = _emulation_share(qkv, "bfloat16", ULP_ATOL, ULP_RTOL,
                                        single_pass_p=True, **kw)
        print(f"split emulation bfloat16 {GEMMA_WIDTH} window {window}: "
              f"{err:.3g} ({share:.3f} of one ulp); single-pass bf16 P "
              f"{err1:.3g} ({share1:.1f} of one ulp)")
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
