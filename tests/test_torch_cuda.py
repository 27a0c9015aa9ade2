"""PyTorch port, the CUDA kernels on the card: each kernel (dense FC, KitNET
ensemble and scoring, Count-Min sketch, single-key update, flash attention)
against its plain PyTorch version at small sizes (the FC, single-key and
sketch kernels bit for bit), at the shapes past the kernels' built sizes
(sketch rows past 8 and 32, AE widths past 32 and 64, flash head dims other
than 32, 64, 128, 256, prefill positions arange(S) + c), launch counting,
and the wrappers' checks (the flash kernel refuses inputs that require a
gradient); the LM families beyond dense (MoE, VLM, audio, hybrid, xLSTM)
on the card against the CPU, and the flash kernel at their shapes; LM
training on the card against the CPU (three steps, remat, int8 error
feedback, microbatches) and resuming on the card.

Marked ``cuda``; each test skips without a CUDA device.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import clone_state, init_state, process_serial
from repro_torch.core.sketch import process_sketch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.feature_update import (TABLE_KEYS, feature_update,
                                                feature_update_full,
                                                feature_update_ref)
from repro_torch.kernels.sketch_update import (kernel_rows, sketch_schedule_ref,
                                               sketch_update_full)
from repro_torch.kernels.kitnet_ae import (kitnet_ensemble, kitnet_ensemble_ref,
                                           kitnet_score, kitnet_score_ref)
from repro_torch.traffic import synth_trace, to_torch

pytestmark = pytest.mark.cuda

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fc_bitwise(dev, pk, n_slots, st0=None):
    """The FC kernel against the serial oracle bit for bit, features and
    every table, from ``st0`` (a fresh state if None); one launch."""
    st0 = init_state(n_slots, device=dev) if st0 is None else st0
    reset_launch_counts()
    st_k, f_k = feature_update_full(clone_state(st0), pk)
    assert launch_counts()["fc_full"] == 1
    st_p, f_p = process_serial(clone_state(st0), pk)
    assert torch.equal(f_k, f_p), float((f_k - f_p).abs().max())
    for g in st_p:
        for k in st_p[g]:
            assert torch.equal(st_k[g][k], st_p[g][k]), (g, k)
    return st_k, f_k


@pytest.mark.parametrize("attack", ["mirai", "arp_mitm", "active_wiretap",
                                    "ssh_bruteforce", "video_injection"])
def test_fc_kernel_matches_plain(dev, attack):
    tr = synth_trace(attack, n_train=64, n_benign_eval=512, n_attack=512,
                     seed=0)["eval"]
    _fc_bitwise(dev, to_torch(tr, dev), 512)


def test_fc_kernel_chunked_carry(dev):
    """Chunks of 250 carried in place equal one shot and the oracle, bit for
    bit; each chunk starts from the state the last one left."""
    pk = to_torch(synth_trace("mirai", n_train=64, n_benign_eval=600,
                              n_attack=600, seed=1)["eval"], dev)
    st_a, f_once = _fc_bitwise(dev, pk, 1024)
    st_b = init_state(1024, device=dev)
    parts = []
    for i in range(0, 1200, 250):
        chunk = {k: v[i:i + 250] for k, v in pk.items()}
        st_b, f = _fc_bitwise(dev, chunk, 1024, st_b)
        parts.append(f)
    assert torch.equal(torch.cat(parts), f_once)
    for g in st_a:
        for k in st_a[g]:
            assert torch.equal(st_a[g][k], st_b[g][k]), (g, k)


def _one_flow(n, alternate):
    """n packets of one flow, 10 ms apart; with ``alternate`` every other
    packet goes the other way (source and destination swapped)."""
    tr = synth_trace("mirai", n_train=64, n_benign_eval=64, n_attack=64,
                     seed=2)["eval"]
    one = {k: np.repeat(v[:1], n) for k, v in tr.items()}
    one["ts"] = np.arange(n, dtype=np.float32) * 0.01
    one["length"] = (60 + np.arange(n) % 1400).astype(tr["length"].dtype)
    if alternate:
        back = np.arange(n) % 2 == 1
        for a, b in (("src", "dst"), ("sport", "dport")):
            one[a][back], one[b][back] = one[b][back], one[a][back].copy()
    return one


@pytest.mark.parametrize("alternate", [False, True])
def test_fc_kernel_bitwise_one_flow(dev, alternate):
    """One flow of 2100 packets: every key type is one segment of 2100, the
    chains run their whole length in one thread each (more than 32 scan
    tiles of positions, so the links come through the tiles' look-back)."""
    _fc_bitwise(dev, to_torch(_one_flow(2100, alternate), dev), 1024)


def test_fc_kernel_bitwise_heavy_hitter(dev):
    """Two thirds of 3000 packets from one source (a segment of about 2000
    in the uni key types, many channels and sockets under it)."""
    tr = synth_trace("mirai", n_train=64, n_benign_eval=1500, n_attack=1500,
                     seed=4)["eval"]
    hot = np.random.default_rng(0).random(len(tr["ts"])) < 2 / 3
    tr["src"] = np.where(hot, tr["src"][0], tr["src"])
    _fc_bitwise(dev, to_torch(tr, dev), 4096)


@pytest.mark.parametrize("m,h", [(10, 8), (3, 3), (16, 12), (32, 24), (33, 25),
                                 (64, 64), (100, 75), (300, 225)])
def test_ensemble_kernel_matches_plain_and_is_batch_independent(dev, m, h):
    """Widths in registers (16, 32, 64), past them with the weights in
    shared memory (100) and in global memory (300)."""
    g = torch.Generator().manual_seed(m)
    k, B = 7, 1000
    x = torch.rand(B, k, m, generator=g).to(dev)
    w1 = (torch.randn(k, m, h, generator=g) * 0.3).to(dev)
    b1 = (torch.randn(k, h, generator=g) * 0.1).to(dev)
    w2 = (torch.randn(k, h, m, generator=g) * 0.3).to(dev)
    b2 = (torch.randn(k, m, generator=g) * 0.1).to(dev)
    mask = (torch.rand(k, m, generator=g) > 0.2).float().to(dev)
    args = (w1, b1, w2, b2, mask)
    got = kitnet_ensemble(x, *args)
    torch.testing.assert_close(got, kitnet_ensemble_ref(x, *args),
                               rtol=1e-5, atol=1e-5)
    chunked = torch.cat([kitnet_ensemble(x[i:i + 37], *args)
                         for i in range(0, B, 37)])
    assert torch.equal(chunked, got)


def test_wrappers_reject_bad_inputs(dev):
    x = torch.rand(8, 2, 4, device=dev)
    w1 = torch.rand(2, 4, 3, device=dev)
    args = (w1, torch.rand(2, 3, device=dev), torch.rand(2, 3, 4, device=dev),
            torch.rand(2, 4, device=dev), torch.ones(2, 4, device=dev))
    with pytest.raises(ValueError, match="float32"):
        kitnet_ensemble(x.double(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        kitnet_ensemble(x.transpose(0, 1).contiguous().transpose(0, 1), *args)
    # widths past 32 run on the kernel (they raised before the limit went)
    big = (torch.rand(8, 2, 33, device=dev), torch.rand(2, 33, 25, device=dev),
           torch.rand(2, 25, device=dev), torch.rand(2, 25, 33, device=dev),
           torch.rand(2, 33, device=dev), torch.ones(2, 33, device=dev))
    reset_launch_counts()
    torch.testing.assert_close(kitnet_ensemble(*big), kitnet_ensemble_ref(*big),
                               rtol=1e-5, atol=1e-5)
    assert launch_counts()["kitnet_ae"] == 1
    with pytest.raises(ValueError, match="float32"):
        kitnet_ensemble(big[0], big[1], big[2], big[3].double(), big[4], big[5])
    st = init_state(64, device=dev)
    pk = to_torch(synth_trace("mirai", n_train=16, n_benign_eval=16,
                              n_attack=16, seed=0)["eval"], "cpu")
    with pytest.raises(ValueError, match="device"):
        feature_update_full(st, pk)


def _score_inputs(dev, B, F, k, m, h, seed):
    """Records X (B, F) and a random net as kitnet_score's arguments: about
    a fifth of the AE slots padded (mask 0, idx 0), three constant feature
    columns, records past the training range on both sides."""
    rng = np.random.default_rng(seed)
    kh = -(-3 * k // 4)
    mask = rng.random((k, m)) > 0.2
    idx = np.where(mask, rng.integers(0, F, (k, m)), 0)
    lo = rng.normal(0.0, 1.0, F)
    hi = lo + rng.uniform(0.0, 2.0, F)
    hi[:3] = lo[:3]
    r_lo = rng.uniform(0.0, 0.1, k)
    X = lo + (hi - lo + 0.1) * rng.uniform(-0.3, 1.6, (B, F))

    def normal(scale, *shape):
        return rng.normal(0.0, scale, shape)

    arrays = [X, idx, mask, normal(0.3, k, m, h), normal(0.1, k, h),
              normal(0.3, k, h, m), normal(0.1, k, m), normal(0.5, k, kh),
              normal(0.1, kh), normal(0.5, kh, k), normal(0.1, k), lo, hi,
              r_lo, r_lo + rng.uniform(0.0, 0.5, k)]
    X, *args = (torch.from_numpy(a.astype(np.int64 if a is idx else np.float32)).to(dev)
                for a in arrays)
    return X, args


@pytest.mark.parametrize("k", [7, 14, 40])
@pytest.mark.parametrize("m,h", [(10, 8), (3, 3), (33, 25), (64, 64), (100, 75),
                                 (300, 225)])
def test_score_kernel_matches_plain_and_is_batch_independent(dev, m, h, k):
    """Widths 3 to 300 at k = 7, 14 and 40: the net in shared memory and,
    where it does not fit, read in global memory; F = 97 takes the
    unaligned row loads; B = 1 and 8 spread a record a block, B = 1000
    takes tiles.  The plain version runs 100 records at a time (it is
    batch-independent bit for bit)."""
    X, args = _score_inputs(dev, 1000, 97, k, m, h, seed=m + k)
    for B in (1, 8, 1000):
        got = kitnet_score(X[:B], *args)
        want = torch.cat([kitnet_score_ref(X[i:min(i + 100, B)], *args)
                          for i in range(0, B, 100)])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    chunked = torch.cat([kitnet_score(X[i:i + 37], *args) for i in range(0, 1000, 37)])
    assert torch.equal(chunked, got)


@pytest.mark.parametrize("F", [80, 97])
def test_score_kernel_chunked_equals_one_shot(dev, F):
    """The service's width (F = 80: 16-byte row loads) and an odd one, in
    slices of 37 records against one shot, bit for bit."""
    X, args = _score_inputs(dev, 8192, F, 14, 10, 8, seed=F)
    reset_launch_counts()
    one = kitnet_score(X, *args)
    assert launch_counts()["kitnet_score"] == 1
    torch.testing.assert_close(one, kitnet_score_ref(X, *args), rtol=1e-5, atol=1e-5)
    chunked = torch.cat([kitnet_score(X[i:i + 37], *args) for i in range(0, 8192, 37)])
    assert torch.equal(chunked, one)


def _ensemble_inputs(dev, B, k, m, h, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, k, m, generator=g).to(dev)
    net = ((torch.randn(k, m, h, generator=g) * 0.3).to(dev),
           (torch.randn(k, h, generator=g) * 0.1).to(dev),
           (torch.randn(k, h, m, generator=g) * 0.3).to(dev),
           (torch.randn(k, m, generator=g) * 0.1).to(dev),
           (torch.rand(k, m, generator=g) > 0.2).float().to(dev))
    return x, net


@pytest.mark.parametrize("B,k,m,h", [(8, 14, 10, 8), (256, 14, 10, 8), (8192, 14, 10, 8),
                                     (1000, 7, 33, 25), (300, 7, 64, 64),
                                     (100, 7, 100, 75)])
def test_ensemble_designs_agree_bitwise(dev, B, k, m, h):
    """kitnet_ae's tile and pair designs, each forced, give the same bits
    (registers up to width 64, the scratch row past it; the net in shared
    memory and, at 64 and 100, in global memory), within 1e-5 of the plain
    version; the launcher's own choice gives them too."""
    x, net = _ensemble_inputs(dev, B, k, m, h, seed=B + m)
    tile = kitnet_ensemble(x, *net, design="tile")
    assert torch.equal(kitnet_ensemble(x, *net, design="pair"), tile)
    assert torch.equal(kitnet_ensemble(x, *net), tile)
    torch.testing.assert_close(tile, kitnet_ensemble_ref(x, *net), rtol=1e-5, atol=1e-5)


def test_ensemble_and_score_past_a_block(dev):
    """k=80 AEs of m=300, h=225: one record's tile values (k (2m + h)
    floats) pass a block's shared memory, so kitnet_ae takes the pair design
    with its scratch row; kitnet_score still keeps a record in shared memory
    there, and at k=120 it keeps it in global memory.  Each within 1e-5 of
    its plain version, chunked (slices of 37) == one shot bit for bit."""
    x, net = _ensemble_inputs(dev, 64, 80, 300, 225, seed=80)
    reset_launch_counts()
    got = kitnet_ensemble(x, *net)
    assert launch_counts()["kitnet_ae"] == 1
    torch.testing.assert_close(got, kitnet_ensemble_ref(x, *net), rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.cat([kitnet_ensemble(x[i:i + 37], *net)
                                  for i in range(0, 64, 37)]), got)
    for k, B in ((80, 40), (120, 16)):
        X, args = _score_inputs(dev, B, 97, k, 300, 225, seed=k)
        got = kitnet_score(X, *args)
        torch.testing.assert_close(got, kitnet_score_ref(X, *args), rtol=1e-5, atol=1e-5)
        assert torch.equal(torch.cat([kitnet_score(X[i:i + 37], *args)
                                      for i in range(0, B, 37)]), got)
    X, args = _score_inputs(dev, 300, 60000, 2, 3, 3, seed=1)   # a wide record: F
    got = kitnet_score(X, *args)
    torch.testing.assert_close(got, kitnet_score_ref(X, *args), rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.cat([kitnet_score(X[i:i + 37], *args)
                                  for i in range(0, 300, 37)]), got)


def test_fused_step_scores_in_one_launch(dev):
    """One step of serving/fused.py: FC, the epoch gather, one kitnet_score
    launch for its records, and no ensemble launch."""
    from repro_torch.serving import DetectionService
    from repro_torch.serving.fused import make_fused_step
    data = synth_trace("syn_dos", n_train=2048, n_benign_eval=512,
                       n_attack=512, seed=0)
    svc = DetectionService(epoch=64, n_slots=256, device=dev)
    svc.observe_stream(data["train"], chunk=512)
    svc.fit(fpr=0.05)
    step = make_fused_step(epoch=64)
    pk = to_torch({key: v[:512] for key, v in data["eval"].items()}, dev)
    reset_launch_counts()
    _, idx, scores, alarms, count = step(svc.state, svc.net, svc.threshold, 0, pk)
    assert launch_counts()["kitnet_score"] == 1 and launch_counts()["kitnet_ae"] == 0
    assert count == 8 and torch.isfinite(scores).all()
    assert torch.equal(alarms, scores > svc.threshold)


def test_score_wrapper_rejects_bad_inputs(dev):
    X, args = _score_inputs(dev, 8, 80, 14, 10, 8, seed=0)
    with pytest.raises(ValueError, match="float32"):
        kitnet_score(X.double(), *args)
    with pytest.raises(ValueError, match="int64"):
        kitnet_score(X, args[0].int(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        kitnet_score(X.t().contiguous().t(), *args)
    with pytest.raises(ValueError, match="on cpu"):
        kitnet_score(X, args[0].cpu(), *args[1:])
    with pytest.raises(ValueError, match=r"\(14,\)"):
        kitnet_score(X, *args[:-1], args[-1][:5])
    with pytest.raises(ValueError, match="X \\(B, F\\)"):
        kitnet_score(X[0], *args)
    x = torch.rand(8, 80, 300, device=dev)
    net = (torch.rand(80, 300, 225, device=dev), torch.rand(80, 225, device=dev),
           torch.rand(80, 225, 300, device=dev), torch.rand(80, 300, device=dev),
           torch.ones(80, 300, device=dev))
    with pytest.raises(ValueError, match="tile design"):
        kitnet_ensemble(x, *net, design="tile")
    with pytest.raises(ValueError, match="design must be one of"):
        kitnet_ensemble(x, *net, design="serial")


def _sketch_bitwise(dev, pk, rows, width, evict_age=0.0):
    """The kernel against the plain version bit for bit, features and every
    table, and the kernel's schedule against its plain twin."""
    st0 = init_state(width, state_backend="sketch", device=dev, rows=rows,
                     evict_age=evict_age)
    sched = {}
    reset_launch_counts()
    st_k, f_k = sketch_update_full(clone_state(st0), pk, schedule=sched)
    assert launch_counts()["sketch_update"] == 1
    st_p, f_p = process_sketch(clone_state(st0), pk)
    assert torch.equal(f_k, f_p)
    for g in ("uni", "bi"):
        for k in st_p[g]:
            assert torch.equal(st_k[g][k], st_p[g][k]), (g, k)
    want = sketch_schedule_ref(kernel_rows(pk, rows, width)[0], width)
    assert sched["depth"] == want["depth"] and sched["rounds"] == want["rounds"]
    for key in ("level", "order"):
        assert torch.equal(sched[key].cpu(), want[key]), key
    for got, ref in zip(sched["round_starts"], want["round_starts"]):
        assert torch.equal(got.cpu(), ref)
    return want


@pytest.mark.parametrize("rows,width,evict_age", [(1, 512, 0.0), (2, 512, 0.0),
                                                  (2, 4096, 0.0), (2, 64, 0.5),
                                                  (3, 64, 0.5), (4, 64, 0.5),
                                                  (8, 64, 0.5)])
def test_sketch_kernel_matches_plain(dev, rows, width, evict_age):
    """600 packets: not a multiple of any round size (512, 256, 128, 64)."""
    pk = to_torch(synth_trace("mirai", n_train=64, n_benign_eval=300,
                              n_attack=300, seed=2)["eval"], dev)
    _sketch_bitwise(dev, pk, rows, width, evict_age)


def test_sketch_kernel_bitwise_past_shared_counts(dev):
    """n > 8192: the level counts live in the scratch buffer."""
    pk = to_torch(synth_trace("mirai", n_train=64, n_benign_eval=4150,
                              n_attack=4150, seed=3)["eval"], dev)
    assert pk["ts"].shape[0] > 8192
    _sketch_bitwise(dev, pk, 2, 4096)


def test_sketch_kernel_bitwise_single_flow(dev):
    """One flow: every packet its own level, a round a packet."""
    tr = synth_trace("mirai", n_train=64, n_benign_eval=300, n_attack=300,
                     seed=2)["eval"]
    n = 700
    one = {k: np.repeat(v[:1], n) for k, v in tr.items()}
    one["ts"] = np.arange(n, dtype=np.float32) * 0.01
    want = _sketch_bitwise(dev, to_torch(one, dev), 2, 4096)
    assert want["depth"] == want["rounds"] == [n] * 4


def test_sketch_rows1_state_equals_dense_kernel(dev):
    pk = to_torch(synth_trace("arp_mitm", n_train=64, n_benign_eval=400,
                              n_attack=400, seed=0)["eval"], dev)
    st_d, _ = feature_update_full(init_state(1024, device=dev), pk)
    st_s, _ = sketch_update_full(init_state(1024, state_backend="sketch",
                                            device=dev, rows=1), pk)
    for g in ("uni", "bi"):
        for k in st_d[g]:
            if k != "rr":
                assert torch.equal(st_s[g][k][:, 0], st_d[g][k]), (g, k)


def test_sketch_service_runs_the_kernel(dev):
    from repro_torch.serving import DetectionService
    data = synth_trace("syn_dos", n_train=2048, n_benign_eval=512,
                       n_attack=512, seed=0)
    svc = DetectionService(epoch=64, n_slots=256, state_backend="sketch",
                           state_kw={"rows": 2}, device=dev)
    reset_launch_counts()
    svc.observe_stream(data["train"], chunk=512)
    svc.fit(fpr=0.05)
    idx, scores, _ = svc.process_stream(data["eval"], chunk=512)
    assert launch_counts()["sketch_update"] == 6 and launch_counts()["fc_full"] == 0
    assert len(idx) == 1024 // 64


@pytest.mark.parametrize("n,n_slots", [(100, 64), (257, 128), (8192, 8192), (3000, 1)])
def test_single_key_kernel_matches_plain(dev, n, n_slots):
    """Bit for bit; n_slots=1 puts every packet in one run."""
    g = torch.Generator().manual_seed(n)
    slots = torch.randint(0, n_slots, (n,), generator=g).to(dev)
    ts = torch.sort(torch.rand(n, generator=g) * 5)[0].to(dev)
    lens = torch.randint(60, 1500, (n,), generator=g).float().to(dev)

    def fresh():
        return {f: torch.full((n_slots, 4), -1.0 if f == "last_t" else 0.0,
                              device=dev) for f in TABLE_KEYS}

    reset_launch_counts()
    t_k, s_k = feature_update(fresh(), slots, ts, lens)
    assert launch_counts()["feature_update"] == 1
    t_p, s_p = feature_update_ref(fresh(), slots, ts, lens)
    assert torch.equal(s_k, s_p)
    for k in TABLE_KEYS:
        assert torch.equal(t_k[k], t_p[k]), k


def test_new_wrappers_reject_bad_inputs(dev):
    pk = to_torch(synth_trace("mirai", n_train=16, n_benign_eval=16,
                              n_attack=16, seed=0)["eval"], "cpu")
    with pytest.raises(ValueError, match="device"):
        sketch_update_full(init_state(64, state_backend="sketch", device=dev,
                                      rows=2), pk)
    # rows past 8 run on the kernel (they raised before the limit went)
    pk9 = to_torch(synth_trace("mirai", n_train=16, n_benign_eval=16,
                               n_attack=16, seed=0)["eval"], dev)
    _sketch_bitwise(dev, pk9, 9, 64)
    tab = {f: torch.zeros(16, 4, device=dev) for f in TABLE_KEYS}
    x = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="slots must lie"):
        feature_update(tab, torch.tensor([0, 1, 2, 16], device=dev), x, x)


FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


def _flash_inputs(dev, B, H, K, Sq, Sk, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((B, H, Sq, D), (B, K, Sk, D), (B, K, Sk, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,D,causal,window,softcap", [
    (1, 8, 4, 200, 200, 256, True, 64, 50.0),    # gemma2's head: GQA, window, softcap
    (1, 8, 4, 130, 130, 256, True, 0, 50.0),     # global layer
    (2, 4, 2, 64, 64, 64, True, 0, 0.0),
    (1, 8, 1, 96, 96, 32, True, 16, 0.0),        # MQA
    (1, 2, 2, 200, 72, 64, False, 0, 0.0),       # ragged Sq > Sk
    (1, 2, 2, 200, 72, 128, True, 0, 30.0),      # ragged, causal top-left
    (2, 4, 4, 1, 128, 32, False, 0, 0.0),        # Sq = 1
    (1, 2, 1, 150, 40, 64, False, 20, 0.0),      # rows that see no key
])
def test_flash_kernel_matches_plain(dev, B, H, K, Sq, Sk, D, causal, window,
                                    softcap, dtype):
    q, k, v = _flash_inputs(dev, B, H, K, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    reset_launch_counts()
    got = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(dev, dtype):
    """The model's (B, S, H, D) projections go in as transposed views, and
    the output comes back laid out as q is."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 130, n, 256, generator=g).to(dev, dtype).transpose(1, 2)
               for n in (8, 4, 4))
    got = flash_attention(q, k, v, causal=True, window=32, softcap=50.0)
    assert got.stride() == q.stride() and got.dtype == dtype
    want = flash_attention_ref(q, k, v, causal=True, window=32, softcap=50.0)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [512, 0])
def test_flash_kernel_bf16_gemma_shape_within_one_ulp(dev, window):
    """bf16 at gemma2's heads: the kernel and its plain version compute in
    float32 and differ only in the output's rounding, one bf16 ulp."""
    q, k, v = _flash_inputs(dev, 1, 8, 4, 1024, 1024, 256, torch.bfloat16, seed=2)
    kw = dict(causal=True, window=window, softcap=50.0)
    got = flash_attention(q, k, v, **kw).float()
    want = flash_attention_ref(q, k, v, **kw).float()
    assert bool(((got - want).abs() <= 1e-5 + 2.0 ** -7 * want.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_kernel_ragged_keys_and_single_query(dev, D, dtype):
    """Sk not a multiple of any key tile (the tail loads as zeros and gets
    no weight), and a single query row."""
    tol = FLASH_TOL[dtype]
    for Sq, Sk, causal in ((77, 77, True), (1, 77, False), (1, 1, False)):
        q, k, v = _flash_inputs(dev, 1, 4, 2, Sq, Sk, D, dtype, seed=Sk)
        got = flash_attention(q, k, v, causal=causal, softcap=30.0)
        want = flash_attention_ref(q, k, v, causal=causal, softcap=30.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_wrapper_rejects_bad_inputs(dev):
    # a head dim the kernel is not built for runs zero-padded (it raised
    # before the limit went); past 256 it raises
    q, k, v = _flash_inputs(dev, 1, 2, 1, 8, 8, 48, torch.float32)
    got = flash_attention(q, k, v)
    assert got.shape == q.shape
    torch.testing.assert_close(got, flash_attention_ref(q, k, v),
                               rtol=FLASH_TOL[torch.float32],
                               atol=FLASH_TOL[torch.float32])
    q, k, v = _flash_inputs(dev, 1, 2, 1, 8, 8, 320, torch.float32)
    with pytest.raises(ValueError, match="head_dim 320"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(dev, 1, 2, 1, 8, 8, 32, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, k.half(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous last dimension"):
        flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    # the tensor maps take 16-byte strides and 16-byte aligned rows
    wide = torch.zeros(1, 2, 8, 34, device=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        flash_attention(wide[..., :32], k, v)               # 136 bytes a row
    with pytest.raises(ValueError, match="16-byte alignment"):
        flash_attention(wide.flatten()[2:2 + 512].view(1, 2, 8, 32), k, v)
    with pytest.raises(ValueError, match="positive strides"):
        flash_attention(q, k[:, :, :1].expand(1, 1, 8, 32), v)       # row stride 0
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    wide = torch.zeros(1, 2, 8, 36, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(wide[..., :32], kb, vb)             # 72 bytes a row
    with pytest.raises(ValueError, match="16-byte alignment"):
        flash_attention(torch.zeros(516, device=dev, dtype=torch.bfloat16)[4:].view(1, 2, 8, 32), kb, vb)


def test_model_prefill_runs_the_kernel(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_arch("gemma2-2b"), head_dim=256)
    model = build_model(cfg, device=dev)
    params = model.init_params(0)
    toks = torch.randint(0, cfg.vocab, (1, 96), device=dev)
    reset_launch_counts()
    logits, _, _ = model.forward(params, {"tokens": toks})
    assert launch_counts()["flash_attention"] == cfg.n_layers
    plain, _, _ = model.forward(params, {"tokens": toks}, attn_impl="plain")
    torch.testing.assert_close(logits, plain, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="arange"):
        model.forward(params, {"tokens": toks, "positions": toks * 0})
    # positions arange(S) + c run the kernel and give the plain route's logits
    shifted = {"tokens": toks, "positions": torch.arange(96, device=dev)[None] + 5}
    reset_launch_counts()
    logits, _, _ = model.forward(params, shifted)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    plain, _, _ = model.forward(params, shifted, attn_impl="plain")
    torch.testing.assert_close(logits, plain, rtol=2e-5, atol=2e-5)


FAMILY_ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "qwen2-vl-72b",
                "hubert-xlarge", "zamba2-2.7b", "xlstm-125m"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_card_matches_cpu(dev, arch):
    """Each family beyond dense, reduced, with the same parameters on the
    card (the flash kernel, one launch an attention application) and on the
    CPU (the plain route): a 24-token prefill and 4 decode steps fed the
    same tokens, within the CPU tests' tolerances (logits 2e-5; 1e-4 for
    the hybrid and the xLSTM, tests/test_archs.py's bound for them)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import build_model
    from repro_torch.models.transformer import n_attn_apps
    cfg = reduced(get_arch(arch))
    models = {d: build_model(cfg, device=d) for d in ("cpu", dev)}
    p_cpu = models["cpu"].init_params(0)
    params = {"cpu": p_cpu, dev: models["cpu"].init_params(0).to(dev)}
    tol = 1e-4 if cfg.family in ("hybrid", "ssm") else 2e-5
    apps = {"hybrid": n_attn_apps(cfg), "ssm": 0}.get(cfg.family, cfg.n_layers)
    g = torch.Generator().manual_seed(0)
    if cfg.is_encoder:
        batch = {"embeds": torch.randn(2, 24, cfg.d_in, generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 28), generator=g)}
    out = {}
    for d, m in models.items():
        b = {k: v[:, :24].to(d) for k, v in batch.items()}
        reset_launch_counts()
        logits, aux, cache = m.forward(params[d], b, build_cache=not cfg.is_encoder,
                                       max_seq=28)
        if d == dev:
            assert launch_counts()["flash_attention"] == apps
        rows = [logits.cpu()]
        for t in range(24, 28) if not cfg.is_encoder else ():
            lg, cache = m.decode_step(params[d], batch["tokens"][:, t:t + 1].to(d), cache)
            rows.append(lg.cpu())
        out[d] = (rows, float(aux))
    for got, want in zip(out[dev][0], out["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert abs(out[dev][1] - out["cpu"][1]) <= 1e-5
    if cfg.is_encoder:
        with pytest.raises(ValueError, match="encoder-only"):
            models[dev].decode_step(params[dev], torch.zeros((1, 1), dtype=torch.long,
                                                             device=dev), {})


@pytest.mark.parametrize("B,H,K,S,D,causal", [(1, 32, 32, 2048, 80, True),
                                              (1, 16, 16, 1500, 80, False)])
def test_flash_kernel_at_the_families_shapes(dev, B, H, K, S, D, causal):
    """zamba2's shared attention (head dim 80, causal) and hubert's encoder
    (head dim 80, no causal mask, 1500 frames), float32 as their prefills
    run, against the plain version (the model path's 2e-5)."""
    q, k, v = _flash_inputs(dev, B, H, K, S, S, D, torch.float32, seed=D + S)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=causal),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rows", [9, 16, 33, 40])
def test_sketch_kernel_bitwise_past_eight_rows(dev, rows):
    """Rows past 8 (the schedule reads rows in turn), 16 (a half warp a
    packet), past 32 (a lane takes two rows); W=64 with eviction."""
    pk = to_torch(synth_trace("mirai", n_train=64, n_benign_eval=300,
                              n_attack=300, seed=2)["eval"], dev)
    _sketch_bitwise(dev, pk, rows, 64, 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 48, 80, 112, 200])
def test_flash_kernel_padded_head_dims(dev, D, dtype):
    """Head dims the kernel is not built for, zero-padded to the next built
    one (80 and 112: zamba2, hubert-xlarge, kimi-k2), scaled by the true D;
    GQA, window and softcap on, and from (B, S, H, D) views."""
    q, k, v = _flash_inputs(dev, 2, 4, 2, 150, 150, D, dtype, seed=D)
    kw = dict(causal=True, window=40, softcap=30.0)
    reset_launch_counts()
    got = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    torch.testing.assert_close(flash_attention(qt, kt, vt, **kw).float(), got.float(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the tenant axis: fc_full over L tenants' lanes of a stacked pool, the engine
# ---------------------------------------------------------------------------
def _tenant_pool(dev, T, n_slots, warm):
    """A T-tenant pool, tenant t warmed on ``warm[t]`` (each a different
    state), through the single-state kernel."""
    from repro_torch.core.state import init_state_stacked, tenant_view
    pool = init_state_stacked(T, n_slots, device=dev)
    for t, tr in enumerate(warm):
        feature_update_full(tenant_view(pool, t), to_torch(tr, dev))
    return pool


def _clone_pool(pool):
    return {g: {k: v.clone() for k, v in pool[g].items()} for g in pool}


@pytest.mark.parametrize("tids", [[0, 2, 3], [3, 1], [0]])
def test_fc_tenants_matches_plain_and_single_launches(dev, tids):
    """One tenant-batched fc_full launch over the lanes of ``tids`` equals
    its plain version (process_serial lane by lane on each tenant's view)
    and one single-state launch a lane, bit for bit, features and every
    pool table; the tenants outside the batch are untouched."""
    from repro_torch.core.state import tenant_view
    from repro_torch.kernels.feature_update import (
        feature_update_full_tenants, feature_update_full_tenants_ref)
    attacks = ["mirai", "syn_dos", "os_scan", "ssdp_flood"]
    warm = [synth_trace(a, n_train=64, n_benign_eval=200, n_attack=200,
                        seed=t)["eval"] for t, a in enumerate(attacks)]
    T = 1 if tids == [0] else 4
    pool = _tenant_pool(dev, T, 512, warm[:T])
    lanes = [synth_trace(attacks[(t + 1) % 4], n_train=64, n_benign_eval=300,
                         n_attack=300, seed=10 + t)["eval"] for t in tids]
    pk = to_torch({k: np.stack([tr[k] for tr in lanes]) for k in lanes[0]}, dev)
    p_k, p_p, p_s = _clone_pool(pool), _clone_pool(pool), _clone_pool(pool)
    reset_launch_counts()
    _, f_k = feature_update_full_tenants(p_k, tids, pk)
    assert launch_counts()["fc_full"] == 1
    _, f_p = feature_update_full_tenants_ref(p_p, tids, pk)
    f_s = torch.stack([feature_update_full(tenant_view(p_s, t),
                                           {k: v[lane] for k, v in pk.items()})[1]
                       for lane, t in enumerate(tids)])
    assert torch.equal(f_k, f_p) and torch.equal(f_k, f_s)
    for g in pool:
        for k in pool[g]:
            assert torch.equal(p_k[g][k], p_p[g][k]), (g, k)
            assert torch.equal(p_k[g][k], p_s[g][k]), (g, k)
            for t in set(range(T)) - set(tids):
                assert torch.equal(p_k[g][k][t], pool[g][k][t]), (g, k, t)


def test_fc_tenants_rejects_bad_inputs(dev):
    from repro_torch.core.state import init_state_stacked
    from repro_torch.kernels.feature_update import feature_update_full_tenants
    pool = init_state_stacked(2, 64, device=dev)
    pk = to_torch({k: np.stack([v[:32], v[:32]]) for k, v in synth_trace(
        "mirai", n_train=16, n_benign_eval=16, n_attack=16, seed=0)["eval"].items()},
        dev)
    with pytest.raises(ValueError, match="distinct"):
        feature_update_full_tenants(pool, [1, 1], pk)
    with pytest.raises(ValueError, match="distinct"):
        feature_update_full_tenants(pool, [0, 2], pk)
    with pytest.raises(ValueError, match=r"\(L=1, chunk\)"):
        feature_update_full_tenants(pool, [0], pk)
    with pytest.raises(ValueError, match="overflow"):
        feature_update_full_tenants(_big_pool(dev), [0], {k: v[:1] for k, v in pk.items()})


def _big_pool(dev):
    """A pool whose combined keys pass int32, 4*T*n_slots = 2^31, its
    tables one element expanded (only the shapes are read)."""
    T, n_slots = 2 ** 14, 2 ** 15

    def t(*shape, dtype=torch.float32):
        return torch.zeros(1, dtype=dtype, device=dev).expand(shape)
    return {"uni": {"last_t": t(T, 2, n_slots, 4), "w": t(T, 2, n_slots, 4),
                    "ls": t(T, 2, n_slots, 4), "ss": t(T, 2, n_slots, 4),
                    "rr": t(T, 2, n_slots, dtype=torch.int32)},
            "bi": {"w": t(T, 2, n_slots, 2, 4)}}


def test_engine_on_the_card_matches_solo_service(dev):
    """Three tenants on three attacks through the engine on the card, each
    equal to its own solo service bit for bit (results and end state); each
    batch of three lanes is one fc_full and one kitnet_score launch; each
    tenant's slot collisions, counted on the card, equal the host count of
    its chunks."""
    from repro_torch.core.state import slot_collisions
    from repro_torch.serving import DetectionEngine, DetectionService
    data = synth_trace("syn_dos", n_train=2048, n_benign_eval=512,
                       n_attack=512, seed=0)
    svc = DetectionService(epoch=64, n_slots=1024, device=dev)
    svc.observe_stream(data["train"], chunk=512)
    svc.fit(fpr=0.05)
    traces = [synth_trace(a, n_train=64, n_benign_eval=600, n_attack=600,
                          seed=5)["eval"] for a in ("mirai", "goldeneye", "fuzzing")]
    eng = DetectionEngine.from_service(svc, n_tenants=4, chunk=512, queue_depth=2)
    tids = [eng.add_tenant() for _ in traces]
    reset_launch_counts()
    out = eng.run(dict(zip(tids, traces)))
    batches = -(-1200 // 512)
    assert launch_counts()["fc_full"] == batches
    assert launch_counts()["kitnet_score"] == batches
    for t, tr in zip(tids, traces):
        solo = DetectionService(epoch=64, n_slots=1024, device=dev,
                                threshold=svc.threshold)
        solo.net = svc.net
        want = solo.process_stream(tr, chunk=512)
        for w, g in zip(want, out[t]):
            np.testing.assert_array_equal(w, g)
        got = eng.pool.read(t)
        for g in ("uni", "bi"):
            for k in got[g]:
                assert torch.equal(got[g][k], solo.state[g][k]), (t, g, k)
        assert eng.stats()["tenants"][t]["slot_collisions"] == sum(
            slot_collisions({k: v[i:i + 512] for k, v in tr.items()}, 1024)["total"]
            for i in range(0, len(tr["ts"]), 512))


# ---------------------------------------------------------------------------
# partitioned FC (plain torch ops on the card, no kernel of their own)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [4, 16])
def test_bucketed_on_the_card_matches_cpu(dev, S):
    """``bucketed`` on the card against the same call on the CPU, in the JAX
    package's scan envelope (tests/test_backends.py: every non-pcc value
    within 1 + 1e-3 * |f|, at least 99.5% of all values; state at rtol
    1e-3, atol 1.0); its record-sampled path equals its full path's rows
    and state bit for bit on the card; no FC kernel launches."""
    from repro_torch.core import FEATURE_NAMES, compute_features
    from repro_torch.core.backends import compute_features_sampled
    tr = synth_trace("mirai", n_train=64, n_benign_eval=500, n_attack=500,
                     seed=2)["eval"]
    reset_launch_counts()
    st_g, f_g = compute_features(init_state(512, device=dev), to_torch(tr, dev),
                                 backend="bucketed", buckets=S)
    assert launch_counts()["fc_full"] == 0
    st_c, f_c = compute_features(init_state(512, device="cpu"), to_torch(tr, "cpu"),
                                 backend="bucketed", buckets=S)
    got, want = f_g.cpu().double(), f_c.double()
    ok = (got - want).abs() <= 1.0 + 1e-3 * want.abs()
    pcc = torch.tensor([n.endswith(":pcc") for n in FEATURE_NAMES])
    assert ok[:, ~pcc].all() and ok.double().mean() >= 0.995
    for g in st_c:
        for k in st_c[g]:
            torch.testing.assert_close(st_g[g][k].cpu(), st_c[g][k], rtol=1e-3,
                                       atol=1.0)
    idx = torch.arange(63, 1000, 64, device=dev)
    st_x, f_x = compute_features_sampled(init_state(512, device=dev),
                                         to_torch(tr, dev), idx,
                                         backend="bucketed", buckets=S)
    assert torch.equal(f_x, f_g[idx])
    for g in st_g:
        for k in st_g[g]:
            assert torch.equal(st_x[g][k], st_g[g][k]), (g, k)


@pytest.mark.parametrize("mode,S", [("exact", 4), ("exact", 16), ("switch", 4)])
def test_sharded_on_the_card_matches_serial(dev, mode, S):
    """``sharded`` on the card equals the card's serial oracle bit for bit,
    features and every table (round-robin counters included)."""
    from repro_torch.core import compute_features
    pk = to_torch(synth_trace("ssh_bruteforce", n_train=64, n_benign_eval=150,
                              n_attack=150, seed=3)["eval"], dev)
    st_s, f_s = process_serial(init_state(512, device=dev), pk, mode=mode)
    st_h, f_h = compute_features(init_state(512, device=dev), pk,
                                 backend="sharded", shards=S, mode=mode)
    assert torch.equal(f_h, f_s), float((f_h - f_s).abs().max())
    for g in st_s:
        for k in st_s[g]:
            assert torch.equal(st_h[g][k], st_s[g][k]), (g, k)


def test_flash_refuses_inputs_that_require_grad(dev):
    """The kernel has no backward: on the card it refuses q/k/v that need a
    gradient; lm_loss takes the plain route and launches it no time."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import lm_batches
    from repro_torch.models import build_model
    q, k, v = _flash_inputs(dev, 1, 2, 1, 16, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        flash_attention(q, k, v)
    model = build_model(reduced(get_arch("gemma2-2b")), device=dev)
    params = model.init_params(0).requires_grad_(True)
    b = {k_: torch.from_numpy(a).to(dev)
         for k_, a in next(lm_batches(model.cfg.vocab, 2, 16, 1)).items()}
    with pytest.raises(ValueError, match="attn_impl='plain'"):
        model.forward(params, b)
    reset_launch_counts()
    loss, _ = model.loss(params, b)
    loss.backward()
    assert launch_counts()["flash_attention"] == 0
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in params.parameters())


# LM training on the card against the CPU: the CPU tests' envelopes against
# JAX (tests/test_torch_training.py), from the same carried state
TRAIN_F32_TOL = 1e-5


def _train_states(dev, tc, arch="gemma2-2b"):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.interop import train_state_from_arrays, train_state_to_arrays
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state
    cfg = reduced(get_arch(arch))
    models = {d: build_model(cfg, device=d) for d in ("cpu", dev)}
    arrays = train_state_to_arrays(init_train_state(models["cpu"], tc, 0))
    return models, {d: train_state_from_arrays(cfg, tc, arrays, device=d)
                    for d in models}


@pytest.mark.parametrize("kw", [dict(), dict(remat="dots"),
                                dict(grad_compression="int8_ef"),
                                dict(microbatches=4)])
def test_train_step_on_card_matches_cpu(dev, kw):
    from repro_torch import tree
    from repro_torch.configs import TrainConfig
    from repro_torch.data import lm_batches
    from repro_torch.training import make_train_step
    tc = TrainConfig(compute_dtype="float32", learning_rate=1e-3, warmup_steps=2, **kw)
    models, states = _train_states(dev, tc)
    steps = {d: make_train_step(m, tc) for d, m in models.items()}
    lrs = []
    for b in lm_batches(models["cpu"].cfg.vocab, 8, 32, 3, seed=1):
        mets = {}
        for d in models:
            batch = {k: torch.from_numpy(a).to(d) for k, a in b.items()}
            states[d], mets[d] = steps[d](states[d], batch)
        lrs.append(float(mets["cpu"]["lr"]))
        for key in ("loss", "grad_norm"):
            want = float(mets["cpu"][key])
            tol = 1e-4 if key == "grad_norm" and kw.get("grad_compression") else TRAIN_F32_TOL
            assert abs(float(mets[dev][key]) - want) <= tol * abs(want), key
        got = torch.cat([t.cpu().flatten() for t in tree.leaves(states[dev]["params"])])
        want = torch.cat([t.flatten() for t in tree.leaves(states["cpu"]["params"])])
        d = (got - want).abs()
        share = 1e-3 if kw.get("grad_compression") else 1e-4
        assert d.max() <= 2 * sum(lrs)
        assert (d > TRAIN_F32_TOL + TRAIN_F32_TOL * want.abs()).float().mean() <= share


def test_resume_on_card_and_checkpoint_on_cpu(dev, tmp_path):
    from repro_torch import tree
    from repro_torch.configs import TrainConfig
    from repro_torch.data import lm_batches
    from repro_torch.training import CheckpointManager, make_train_step
    from repro_torch.training.fault import FailureInjector, resilient_loop
    tc = TrainConfig(learning_rate=1e-3)
    models, states = _train_states(dev, tc)
    step = make_train_step(models[dev], tc)
    batches = [{k: torch.from_numpy(a).to(dev) for k, a in b.items()}
               for b in lm_batches(models[dev].cfg.vocab, 4, 16, 12, seed=4)]
    ref = tree.tree_map(torch.clone, states[dev])
    for b in batches:
        ref, _ = step(ref, b)
    ckpt = CheckpointManager(str(tmp_path / "ft"), keep=3)
    out = resilient_loop(step, states[dev], batches, ckpt, ckpt_every=2,
                         injector=FailureInjector(fail_at=[3, 7, 7]), max_restarts=5)
    assert out["restarts"] >= 2 and out["completed"] == len(batches)
    for a, b in zip(tree.leaves(out["state"]["params"]), tree.leaves(ref["params"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    restored, rstep = ckpt.restore(states["cpu"])
    assert rstep == len(batches)
    for a, b in zip(tree.leaves(restored), tree.leaves(out["state"])):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())
