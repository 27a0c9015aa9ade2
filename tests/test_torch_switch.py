"""PyTorch port, switch-mode arithmetic: ``core/arith.py``'s switch
functions and ``process_serial(mode="switch")`` against the JAX package,
and against an independent integer reference.

The port computes the switch's shifts exactly (exponents from ``frexp``,
powers of two from their bits), while the JAX package takes ``floor``/
``ceil``/``round`` of XLA's ``log2`` and multiplies by XLA's ``exp2`` of an
integer, which miss the exact value at some operands.  So the two agree
except on a set computed here from JAX's own outputs: the operands whose
JAX exponent is not the exact one, or whose JAX power of two is inexact.
The tests assert that the outputs differ only inside that set and that the
``log2`` misses stay few (at most 10 operands of the grid per rounding).

``process_serial(mode="switch")`` is held to JAX's on every attack: the
round-robin counters and every table but ``sr`` equal bit for bit; ``sr``
within rtol 1e-5 (XLA contracts ``sr * dsr + r * r_opp`` into a fused
multiply-add, the port does not); features equal except at most
``MAX_FEATURE_DIFFS`` values of a trace, each off by at most one floor step
(1.0), all traced to XLA's ``exp2`` in the math-unit square root.  Print
the readings with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_switch.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arith as jax_arith
from repro.core import init_state as jax_init_state
from repro.core import process_serial as jax_process_serial
from repro.traffic.generator import ATTACKS, benign_trace

from repro_torch.core import (FEATURE_NAMES, N_FEATURES, clone_state,
                              compute_features, init_state, process_serial)
from repro_torch.core import arith
from repro_torch.serving import DetectionService
from repro_torch.traffic import synth_trace, to_torch

torch.set_num_threads(1)

N_PKTS = 256
N_SLOTS = 256
MAX_LOG2_MISSES = 10
MAX_FEATURE_DIFFS = 64          # of a trace's 256 * 80 values; 35 measured
SR_TOL = dict(rtol=1e-5, atol=1e-6)


def _grid() -> np.ndarray:
    """Every integer 1..2^22, the powers of two 2^0..2^30, random floats
    in [1, 2^40) and in [-2, 1) (masked to 0 by every function)."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.arange(1, 2 ** 22 + 1, dtype=np.float32),
        np.ldexp(np.float32(1), np.arange(31)).astype(np.float32),
        np.exp(rng.uniform(0, np.log(2.0 ** 40), 200_000)).astype(np.float32),
        rng.uniform(-2, 1, 1000).astype(np.float32)])


@pytest.fixture(scope="module")
def grid():
    return _grid()


def _exact_exponents(x: np.ndarray):
    """floor/ceil/round(log2 x) from numpy's frexp, exact for float32."""
    m, e = np.frexp(x)
    half_sqrt2 = np.nextafter(np.float32(np.sqrt(0.5)), np.float32(1))
    return {"floor": e - 1, "ceil": np.where(m == 0.5, e - 1, e),
            "round": np.where(m < half_sqrt2, e - 1, e)}


def _jax_exponents(x: np.ndarray):
    lg = np.asarray(jnp.log2(jnp.maximum(jnp.asarray(x), 1e-12)))
    return {"floor": np.floor(lg), "ceil": np.ceil(lg), "round": np.round(lg)}


def _exp2_bad(k: np.ndarray) -> np.ndarray:
    """Whether XLA's exp2 at the integer exponent k is not exactly 2^k."""
    ks = np.arange(-126, 128)
    bad = ks[np.asarray(jnp.exp2(jnp.asarray(ks, jnp.float32)))
             != np.ldexp(np.float32(1), ks).astype(np.float32)]
    return np.isin(k, bad)


def _misses(x: np.ndarray, rounding: str) -> np.ndarray:
    """Operands >= 1 whose JAX exponent is not the exact one."""
    return (x >= 1) & (_jax_exponents(x)[rounding] != _exact_exponents(x)[rounding])


def _jax_miss_set(fn: str, x: np.ndarray) -> np.ndarray:
    """Where the JAX package's ``fn`` cannot be exact: its exponent is not
    the exact one, or XLA's power of two at its exponent is inexact."""
    je = _jax_exponents(x)
    if fn == "shift_div":
        return _misses(x, "ceil") | _exp2_bad(-je["ceil"])
    if fn == "shift_mul":
        return _misses(x, "round") | _exp2_bad(je["round"])
    e = je["floor"]
    if fn == "mathunit_square":
        return _misses(x, "floor") | _exp2_bad(-e) | _exp2_bad(e)
    e_even = 2 * np.floor(e / 2)
    return _misses(x, "floor") | _exp2_bad(-e_even) | _exp2_bad(e_even / 2)


def _run(fn: str, x: np.ndarray):
    if fn in ("shift_div", "shift_mul"):
        a = np.random.default_rng(1).permutation(x)     # dividends, factors
        return (np.asarray(getattr(jax_arith, fn)(jnp.asarray(a), jnp.asarray(x))),
                getattr(arith, fn)(torch.from_numpy(a), torch.from_numpy(x)).numpy())
    return (np.asarray(getattr(jax_arith, fn)(jnp.asarray(x))),
            getattr(arith, fn)(torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# the arithmetic against JAX's
# ---------------------------------------------------------------------------
def test_jax_log2_misses_are_few(grid):
    """Where XLA's log2 misses the integer exponent over the grid: the
    operands on which the two packages may take different shifts."""
    counts = {r: int(_misses(grid, r).sum()) for r in ("floor", "ceil", "round")}
    print("JAX log2 misses over the grid:", counts,
          "XLA exp2 inexact at", int(_exp2_bad(np.arange(-31, 32)).sum()),
          "of the 63 exponents -31..31")
    assert all(c <= MAX_LOG2_MISSES for c in counts.values()), counts
    # powers of two themselves are among the misses (log2(8192) < 13)
    assert _misses(np.float32([8192.0]), "floor").all()


@pytest.mark.parametrize("fn", ["shift_div", "shift_mul", "mathunit_square",
                                "mathunit_sqrt"])
def test_switch_fn_matches_jax_outside_its_misses(grid, fn):
    want, got = _run(fn, grid)
    differ = ~((want == got) | (np.isnan(want) & np.isnan(got)))
    allowed = _jax_miss_set(fn, grid)
    print(f"{fn}: {int(differ.sum())} of {len(grid)} operands differ; JAX "
          f"cannot be exact on {int(allowed.sum())}")
    assert not (differ & ~allowed).any(), grid[differ & ~allowed][:10]
    assert (got[grid < 1] == 0).all()


def test_quantized_decay_matches_jax_outside_exp2_misses():
    lam = np.float32([10.0, 1.0, 0.1, 1.0 / 60.0])
    dt = np.concatenate([np.float32([-1.0, 0.0]),
                         np.random.default_rng(2).exponential(3.0, 5000)
                         .astype(np.float32)])[:, None]
    want = np.asarray(jax_arith.quantized_decay(jnp.asarray(lam), jnp.asarray(dt)))
    got = arith.quantized_decay(torch.from_numpy(lam), torch.from_numpy(dt)).numpy()
    k = np.clip(np.floor(lam * np.maximum(dt, 0)), 0, 31)
    assert not ((want != got) & ~_exp2_bad(-k)).any()
    np.testing.assert_array_equal(got, np.ldexp(np.float32(1), -k.astype(int)))


# ---------------------------------------------------------------------------
# the arithmetic against an independent integer reference
# ---------------------------------------------------------------------------
def test_shifts_exact_against_integer_reference():
    """Integer operands with Python ints: a right shift by ceil(log2 b),
    a left shift by round(log2 b), and the math unit's bucket and exponent
    arithmetic (its table entries are the only float values)."""
    rng = np.random.default_rng(3)
    b = np.concatenate([rng.integers(1, 2 ** 22 + 1, 20_000),
                        2 ** np.arange(23), 2 ** np.arange(1, 23) - 1,
                        2 ** np.arange(1, 23) + 1])
    a = rng.integers(-2 ** 20, 2 ** 20, len(b))
    bt, at = torch.from_numpy(b.astype(np.float32)), torch.from_numpy(a.astype(np.float32))
    div = arith.shift_div(at, bt).numpy()
    mul = arith.shift_mul(at, bt).numpy()
    sq = arith.mathunit_square(bt).numpy()
    rt = arith.mathunit_sqrt(bt).numpy()
    for i, (ai, bi) in enumerate(zip(a.tolist(), b.tolist())):
        e_ceil = (bi - 1).bit_length()
        e_floor = bi.bit_length() - 1
        e_round = e_floor + (bi * bi >= 1 << (2 * e_floor + 1))
        assert div[i] == ai >> e_ceil, (ai, bi)
        assert mul[i] == ai << e_round, (ai, bi)
        j = ((bi - (1 << e_floor)) << 4) >> e_floor          # bucket of 16
        assert sq[i] == ((33 + 2 * j) ** 2 << (2 * e_floor)) >> 10, bi
        h = e_floor // 2
        j = ((bi - (1 << 2 * h)) << 4) // (3 << 2 * h)
        lut = float(np.sqrt(np.float32((35 + 6 * j) / 32)))  # float32 root
        assert rt[i] == int(lut * (1 << h)), bi


# ---------------------------------------------------------------------------
# the serial oracle in switch mode
# ---------------------------------------------------------------------------
def _trace(attack: str, seed: int = 0):
    """The JAX package's backend-parity traces (256 packets)."""
    rng = np.random.default_rng(seed)
    ben = benign_trace(160, 6.0, rng)
    atk = ATTACKS[attack](120, 1.0, 5.0, rng)
    out = {k: np.concatenate([ben[k], atk[k]]) for k in ben}
    order = np.argsort(out["ts"], kind="stable")
    return {k: v[order][:N_PKTS] for k, v in out.items() if k != "label"}


def _switch_readings(attack: str):
    tr = _trace(attack)
    st_j, f_j = jax_process_serial(jax_init_state(N_SLOTS),
                                   {k: jnp.asarray(v) for k, v in tr.items()},
                                   mode="switch")
    st_t, f_t = process_serial(init_state(N_SLOTS, device="cpu"),
                               to_torch(tr, "cpu"), mode="switch")
    f_j, f_t = np.asarray(f_j), f_t.numpy()
    differ = f_j != f_t
    cols = sorted({FEATURE_NAMES[c] for c in np.nonzero(differ)[1]})
    return st_j, st_t, f_j, f_t, differ, cols


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_process_serial_switch_matches_jax(attack):
    st_j, st_t, f_j, f_t, differ, cols = _switch_readings(attack)
    print(f"{attack}: {int(differ.sum())} feature values differ, in {cols}; "
          f"largest {np.abs(f_j - f_t).max()}")
    assert f_t.shape == (N_PKTS, N_FEATURES) and np.isfinite(f_t).all()
    assert differ.sum() <= MAX_FEATURE_DIFFS
    assert np.abs(f_j - f_t).max() <= 1.0
    for g in ("uni", "bi"):
        for k in st_t[g]:
            want, got = np.asarray(st_j[g][k]), st_t[g][k].numpy()
            if (g, k) == ("bi", "sr"):
                np.testing.assert_allclose(got, want, err_msg=attack, **SR_TOL)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{attack} {g}/{k}")
    # the JAX package's property (tests/test_core.py): floored shifts make
    # the mean and std columns integer-valued
    names = np.array([n.rsplit(":", 1)[1] for n in FEATURE_NAMES])
    ms = np.isin(names, ["mean", "std"])
    np.testing.assert_array_equal(f_t[:, ms], np.round(f_t[:, ms]))
    assert (st_t["uni"]["rr"] > 0).any() and (st_t["bi"]["rr"] > 0).any()


def test_switch_chunked_equals_one_shot():
    pk = to_torch(_trace("mirai"), "cpu")
    st1, f1 = process_serial(init_state(N_SLOTS, device="cpu"), pk, mode="switch")
    st2 = init_state(N_SLOTS, device="cpu")
    parts = []
    for i in range(0, N_PKTS, 100):
        st2, f = compute_features(st2, {k: v[i:i + 100] for k, v in pk.items()},
                                  backend="serial", mode="switch")
        parts.append(f)
    assert torch.equal(torch.cat(parts), f1)
    for g in st1:
        for k in st1[g]:
            assert torch.equal(st1[g][k], st2[g][k]), (g, k)


@pytest.mark.parametrize("backend", ["cuda", "pallas", "scan", "parallel"])
def test_exact_only_backends_reject_switch(backend):
    st = init_state(64, device="cpu")
    pk = to_torch(_trace("syn_dos"), "cpu")
    with pytest.raises(ValueError, match="serial"):
        compute_features(st, pk, backend=backend, mode="switch")
    with pytest.raises(ValueError, match="unknown arithmetic mode"):
        compute_features(st, pk, backend="serial", mode="turbo")


def test_service_switch_mode_staged_equals_fused():
    """Switch mode: backend ``serial`` and the staged path by default; the
    per-chunk step (``fused=True``) gives the same indices and scores."""
    data = synth_trace("syn_dos", n_train=256, n_benign_eval=200,
                       n_attack=200, seed=1)
    svc = DetectionService(epoch=16, n_slots=N_SLOTS, mode="switch",
                           device="cpu")
    assert svc.backend == "serial" and svc.fused is False
    svc.observe_stream(data["train"], chunk=100)
    svc.fit(seed=0, fpr=0.05)
    st0, c0 = clone_state(svc.state), svc.pkt_count
    staged = svc.process_stream(data["eval"], chunk=128)
    svc.state, svc.pkt_count = st0, c0
    fused = svc.process_stream(data["eval"], chunk=128, fused=True)
    assert len(staged[0]) == len(data["eval"]["ts"]) // 16
    for a, b in zip(staged, fused):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    g = _grid()
    test_jax_log2_misses_are_few(g)
    for name in ("shift_div", "shift_mul", "mathunit_square", "mathunit_sqrt"):
        test_switch_fn_matches_jax_outside_its_misses(g, name)
    for atk in sorted(ATTACKS):
        *_, f_j, f_t, differ, cols = _switch_readings(atk)
        print(f"{atk}: {int(differ.sum())} values differ in {cols}, "
              f"largest {np.abs(f_j - f_t).max()}")
