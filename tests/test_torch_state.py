"""PyTorch port, flow state and hashing: slot indices and direction bits are
bit-exact against the JAX package on every attack generator, the feature
names and fresh tables are identical, record sampling agrees, and the port
imports neither JAX nor the JAX package."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core import packet_slots as jax_packet_slots
from repro.core.records import epoch_gather as jax_epoch_gather
from repro.core.state import FEATURE_NAMES as JAX_FEATURE_NAMES
from repro.traffic.generator import ATTACKS, attack_trace, benign_trace

from repro_torch.core import (FEATURE_NAMES, LAMBDAS, N_FEATURES, epoch_gather,
                              epoch_indices, init_state, packet_slots)
from repro_torch.core.state import KEY_SALTS, hash_fields
from repro_torch.traffic import to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _trace(attack: str, n: int = 512, seed: int = 0):
    rng = np.random.default_rng(seed)
    ben = benign_trace(n // 2, 6.0, rng)
    atk = ATTACKS[attack](n // 2, 1.0, 5.0, rng)
    out = {k: np.concatenate([ben[k], atk[k]]) for k in ben}
    order = np.argsort(out["ts"], kind="stable")
    return {k: v[order] for k, v in out.items()}


@pytest.mark.parametrize("n_slots", [512, 8192])
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_packet_slots_bit_exact(attack, n_slots):
    tr = _trace(attack)
    want = jax_packet_slots({k: jnp.asarray(v) for k, v in tr.items()
                             if k != "label"}, n_slots)
    got = packet_slots(to_torch(tr, "cpu"), n_slots)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{attack}/{k}")


def test_hash_full_uint32_range():
    """Fields near 2^32 (where a signed product would overflow) hash
    exactly as the uint32 reference does."""
    rng = np.random.default_rng(0)
    f = [rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
         for _ in range(3)]
    f[0][:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    from repro.core.state import np_hash_fields
    for salt in KEY_SALTS.values():
        got = hash_fields(tuple(torch.from_numpy(a.astype(np.int64)) for a in f),
                          salt)
        np.testing.assert_array_equal(got.numpy(),
                                      np_hash_fields(f, salt).astype(np.int64))


def test_to_torch_keeps_unsigned_order():
    tr = attack_trace("syn_dos", 64, 0.0, 1.0, seed=0)   # WAN block >= 2^31
    pk = to_torch(tr, "cpu")
    assert "label" not in pk
    assert pk["src"].dtype == torch.int64 and pk["ts"].dtype == torch.float32
    np.testing.assert_array_equal(pk["src"].numpy(), tr["src"].astype(np.int64))
    assert int(pk["src"].min()) >= 2 ** 31


def test_feature_names_and_constants():
    assert FEATURE_NAMES == JAX_FEATURE_NAMES
    assert N_FEATURES == len(FEATURE_NAMES) == 80
    assert LAMBDAS == (10.0, 1.0, 0.1, 1.0 / 60.0)


def test_init_state_matches_jax():
    want = jax_init_state(512)
    got = init_state(512, device="cpu")
    assert set(got) == set(want)
    for g in want:
        assert set(got[g]) == set(want[g])
        for k in want[g]:
            w = np.asarray(want[g][k])
            assert got[g][k].numpy().dtype == w.dtype, (g, k)
            np.testing.assert_array_equal(got[g][k].numpy(), w, err_msg=f"{g}/{k}")


def test_unported_layouts_raise():
    with pytest.raises(ValueError, match="unknown state backend"):
        init_state(64, state_backend="bloom", device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(64)


@pytest.mark.parametrize("offset", [0, 5, 63, 64, 1000, 2 ** 40 + 3])
def test_epoch_gather_matches_indices_and_jax(offset):
    n, epoch = 300, 64
    idx, count = epoch_gather(n, epoch, offset % epoch)
    want = epoch_indices(n, epoch, offset)
    assert count == len(want)
    np.testing.assert_array_equal(idx.numpy()[:count], want)
    assert (idx.numpy()[count:] == 0).all()
    j_idx, j_count = jax_epoch_gather(n, epoch, jnp.int32(offset % epoch))
    assert int(j_count) == count
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the JAX
    package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "assert len(mods) >= 20, mods\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
