"""F3: a bit flip that makes a NaN (or an inf) in a checksummed block is
flagged uncorrectable by the port at each of its three ABFT checks, where
the reference's `|res| > tau` compares False and lets it through (a
deliberate divergence, ROADMAP F3): `abft/ref.py::verify_and_correct`
(K3's product and the logits guards), `attention_verify` (K4's checksum
lane) and `abft/executor.py::pack_checksum_guard` (the admission verdict
per prompt). Each case runs the reference's function on the same block and
asserts that it still misses the fault, so the caveat stays documented;
the clean and finite-fault cases agree with the reference exactly."""
import signal

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.abft import executor as jexec
from repro.abft import ref as jref
from repro.core.injection import InjectionSpec as JSpec

from repro_torch.abft import executor as texec
from repro_torch.abft import ref as tref
from repro_torch.core.injection import InjectionSpec
from repro_torch.runtime.prefill import VERDICT_BAD, VERDICT_CLEAN

torch.set_num_threads(1)

TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own time limit: SIGALRM fails it past TEST_TIMEOUT_S."""
    def expired(signum, frame):
        raise TimeoutError(f"test ran past {TEST_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _flip(a: np.ndarray, idx, bit: int) -> np.ndarray:
    a = a.copy()
    a.view(np.uint32)[idx] ^= np.uint32(1 << bit)
    return a


def _product(seed: int = 0, m: int = 6, n: int = 16, k: int = 5):
    r = np.random.RandomState(seed)
    a = r.standard_normal((m, n)).astype(np.float32)
    b = r.standard_normal((n, k)).astype(np.float32)
    a_c, b_r = tref.checksum_encode(torch.from_numpy(a), torch.from_numpy(b))
    return torch.matmul(a_c, b_r).numpy(), n


def _report(rep):
    return {f: bool(getattr(rep, f)) for f in
            ("detected", "corrected", "uncorrectable")}


@pytest.mark.parametrize("case", ["nan", "inf", "finite", "clean"])
def test_verify_and_correct_flags_a_non_finite_residual(case):
    c_full, n = _product()
    i, j = 2, 3
    if case == "nan":
        c_full[i, j] = 1.25               # in [1, 2): bit 30 -> NaN
        c_full = _flip(c_full, (i, j), 30)
        assert np.isnan(c_full[i, j])
    elif case == "inf":
        c_full[i, j] = np.inf
    elif case == "finite":
        c_full = _flip(c_full, (i, j), 27)
    out, rep = tref.verify_and_correct(torch.from_numpy(c_full), n)
    jout, jrep = jref.verify_and_correct(jnp.asarray(c_full), n)
    if case in ("clean", "finite"):
        assert _report(rep) == _report(jrep)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        assert _report(rep)["detected"] == (case == "finite")
        return
    assert _report(rep) == dict(detected=True, corrected=False,
                                uncorrectable=True)
    assert int(rep.bad_rows) == 1 and int(rep.bad_cols) == 1
    # the reference misses it: no detection, the block passes as it is
    assert not bool(jrep.detected) or case == "inf"
    if case == "nan":
        assert np.isnan(np.asarray(jout)[i, j])


@pytest.mark.parametrize("bad", [False, True])
def test_attention_verify_flags_a_nan_lane(bad):
    r = np.random.RandomState(1)
    B, H, S, hd = 1, 2, 4, 8
    out = r.standard_normal((B, H, S, hd)).astype(np.float32)
    full = np.concatenate([out, out.sum(-1, keepdims=True)], axis=-1)
    if bad:
        full[0, 1, 2, 3] = 1.5
        full[0, 1, 2, 4] = np.nan        # a data lane made a NaN
    _, rep = tref.attention_verify(torch.from_numpy(full), S)
    _, jrep = jref.attention_verify(jnp.asarray(full), S)
    assert bool(rep.detected) == bool(rep.uncorrectable) == bad
    assert not bool(rep.corrected)
    assert not bool(jrep.detected)       # the reference misses it
    if bad:
        assert int(rep.bad_rows) == 1


def test_pack_checksum_guard_rejects_the_nan_row_only():
    """The admission guard of a packed prefill: element (1, 5) of the
    (K, V) logits block lies in [1, 2), bit 30 makes it a NaN. The port
    localizes the fault to prompt 1 (VERDICT_BAD) and admits the others;
    the reference admits every row."""
    r = np.random.RandomState(2)
    K, V = 3, 11
    lg = (0.3 * r.standard_normal((K, V))).astype(np.float32)
    lg[1, 5] = 1.25
    spec = dict(leaf_idx=0, flat_idx=1 * (V + 1) + 5, bit=30, step=4,
                replica=0, target="prefill_kernel")
    out, verdict, rep = texec.pack_checksum_guard(
        torch.from_numpy(lg), InjectionSpec(**spec), 4, True)
    assert verdict.tolist() == [VERDICT_CLEAN, VERDICT_BAD, VERDICT_CLEAN]
    assert bool(rep.uncorrectable) and not bool(rep.corrected)
    _, jverdict, jrep = jexec.pack_checksum_guard(
        jnp.asarray(lg), JSpec(**spec), 4, True)
    assert not bool(jrep.detected)
    assert np.asarray(jverdict).tolist() == [VERDICT_CLEAN] * K
