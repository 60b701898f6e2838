"""The port's ABFT subsystem against the JAX reference's, on the CPU: the
plain math (`abft/ref.py`), the kernel-domain fault model, the K3/K4
wrappers (their plain versions here) against the reference's Pallas
kernels in interpret mode, the 12-scenario campaign, and the replica-free
executor through the engine.

Tolerances: outputs within atol 1e-5 (f32 sums in another order);
report counts and flags exactly; `max_residual` within rtol 1e-5, plus atol
1e-5 for a clean block, whose residuals are rounding noise of ~1e-6 that
depends on the summation order.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.abft import abft_flash_attention as j_abft_flash_attention
from repro.abft import abft_matmul as j_abft_matmul
from repro.abft.executor import AbftExecutor as JAbftExecutor
from repro.abft.ref import abft_attention_ref as j_abft_attention_ref
from repro.abft.ref import abft_matmul_ref as j_abft_matmul_ref
from repro.abft.ref import checksum_encode as j_checksum_encode
from repro.abft.ref import residual_threshold as j_residual_threshold
from repro.abft.ref import verify_and_correct as j_verify_and_correct
from repro.configs import SedarConfig as JSedarConfig
from repro.core import fingerprint as jfp
from repro.core.detection import SedarSafeStop as JSafeStop
from repro.core.engine import BoundarySchedule as JSchedule
from repro.core.injection import InjectionSpec as JSpec
from repro.core.injection import MemoryInjectionFlag as JFlag
from repro.core.injection import flip_bit as j_flip_bit
from repro.core.injection import make_kernel_fault as j_make_kernel_fault
from repro.core.policy import make_engine as jmake_engine
from repro.core.recovery import RetryRecovery as JRetry
from repro.core.scenarios import run_abft_campaign as j_run_abft_campaign

from repro_torch.abft import (AbftExecutor, abft_attention_ref,
                              abft_flash_attention, abft_matmul, matmul_kernel)
from repro_torch.abft import kernels as kab
from repro_torch.abft.ref import verify_and_correct
from repro_torch.configs import SedarConfig
from repro_torch.core import fingerprint as tfp
from repro_torch.core import hostsync
from repro_torch.core.detection import SedarSafeStop
from repro_torch.core.engine import BoundarySchedule
from repro_torch.core.injection import (InjectionSpec, MemoryInjectionFlag,
                                        flip_bit, make_kernel_fault)
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import RetryRecovery, SafeStop
from repro_torch.core.scenarios import run_abft_campaign

torch.set_num_threads(1)

FIELDS = ("detected", "corrected", "uncorrectable", "bad_rows", "bad_cols")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_reports_equal(got, want, clean_block=False):
    for f in FIELDS:
        assert _np(getattr(got, f)).item() == _np(getattr(want, f)).item(), f
    np.testing.assert_allclose(_np(got.max_residual), _np(want.max_residual),
                               rtol=1e-5, atol=1e-5 if clean_block else 0)


def _ab(m=24, n=16, k=20, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, n).astype(np.float32),
            rs.randn(n, k).astype(np.float32))


def _flip(c, flat_idx, bit, n_elems=1):
    """Bit flips as the kernel fault model places them, in numpy."""
    u = c.copy().reshape(-1).view(np.uint32)
    for e in range(n_elems):
        u[(flat_idx + e * (c.shape[-1] + 1)) % u.size] ^= np.uint32(1 << bit)
    return u.view(np.float32).reshape(c.shape)


def _clean_full(a, b):
    a_c, b_r = j_checksum_encode(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(jnp.dot(a_c, b_r, preferred_element_type=jnp.float32))


def _one_sided(c_full):
    """The delta of test_abft.py's one-sided case: between the row and the
    column threshold of element (0, 0) of a tall-thin product."""
    m, k = c_full.shape[0] - 1, c_full.shape[1] - 1
    clean = jnp.asarray(c_full[:m, :k])
    row_tau = float(j_residual_threshold(jnp.sum(jnp.abs(clean), axis=1),
                                         16 + 128)[0])
    col_tau = float(j_residual_threshold(jnp.sum(jnp.abs(clean), axis=0),
                                         16 + 128)[0])
    assert row_tau < 0.5 * (row_tau + col_tau) < col_tau
    out = c_full.copy()
    out[0, 0] += np.float32(0.5 * (row_tau + col_tau))
    return out


def _case(name):
    if name == "one_sided":
        return _one_sided(_clean_full(*_ab(128, 16, 8, seed=3))), 16
    a, b = _ab()
    c = _clean_full(a, b)
    if name == "single_flip":
        c = _flip(c, 37, 21)
    elif name == "three_elements":
        c = _flip(c, 37, 21, n_elems=3)
    elif name == "checksum_entry":
        c = c.copy()
        c[2, b.shape[1]] += np.float32(1.0)
    elif name == "low_bit":
        c = _flip(c, 37, 0)
    return c, a.shape[1]


# (case, detected, corrected): the reference's verdict, checked in both
REF_CASES = [("clean", False, False), ("single_flip", True, True),
             ("three_elements", True, False), ("one_sided", True, True),
             ("checksum_entry", True, True), ("low_bit", False, False)]


@pytest.mark.parametrize("case,detected,corrected", REF_CASES)
def test_verify_and_correct_matches_reference(case, detected, corrected):
    c_full, inner = _case(case)
    jout, jrep = j_verify_and_correct(jnp.asarray(c_full), inner)
    out, rep = verify_and_correct(torch.from_numpy(c_full.copy()), inner)
    assert bool(jrep.detected) == detected and bool(jrep.corrected) == corrected
    _assert_reports_equal(rep, jrep, clean_block=not detected)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=1e-5, rtol=0)
    if case == "checksum_entry":   # data block untouched, bit for bit
        np.testing.assert_array_equal(_np(out), c_full[:-1, :-1])


@pytest.mark.parametrize("n_elems", [1, 3])
def test_kernel_fault_bitwise_equal_to_reference(n_elems):
    c = _clean_full(*_ab())
    jspec = JSpec(leaf_idx=0, flat_idx=37, bit=21, step=4, target="kernel",
                  n_elems=n_elems, dtype="float32")
    spec = InjectionSpec(leaf_idx=0, flat_idx=37, bit=21, step=4,
                         target="kernel", n_elems=n_elems, dtype="float32")
    want = np.asarray(j_make_kernel_fault(jspec, step=jnp.asarray(4),
                                          armed=jnp.asarray(True))(
        jnp.asarray(c)))
    got = _np(make_kernel_fault(spec, step=4, armed=True)(
        torch.from_numpy(c.copy())))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(got, c)
    t = torch.from_numpy(c.copy())
    for step, armed in ((4, False), (3, True)):
        assert make_kernel_fault(spec, step=step, armed=armed)(t) is t
    with pytest.raises(ValueError, match="target='kernel'"):
        make_kernel_fault(InjectionSpec(leaf_idx=0, flat_idx=0, bit=1,
                                        step=0), step=0, armed=True)


def _fault_pair(flat_idx=37, bit=21, n_elems=1):
    kw = dict(leaf_idx=0, flat_idx=flat_idx, bit=bit, step=0,
              target="kernel", n_elems=n_elems, dtype="float32")
    return (j_make_kernel_fault(JSpec(**kw), step=jnp.asarray(0),
                                armed=jnp.asarray(True)),
            make_kernel_fault(InjectionSpec(**kw), step=0, armed=True))


@pytest.mark.parametrize("m,n,k", [(24, 16, 20), (7, 5, 3)])
@pytest.mark.parametrize("fault", [None, 1, 3])
def test_abft_matmul_plain_path_matches_reference_pallas(m, n, k, fault):
    a, b = _ab(m, n, k)
    jinj = inj = None
    if fault is not None:
        jinj, inj = _fault_pair(n_elems=fault)
    jc, jrep = j_abft_matmul(jnp.asarray(a), jnp.asarray(b), inject=jinj,
                             block_m=8, block_n=8, block_k=8, interpret=True)
    before = kab.matmul_launch_count.n
    c, rep = abft_matmul(torch.from_numpy(a), torch.from_numpy(b), inject=inj)
    assert kab.matmul_launch_count.n == before      # the CPU takes the plain
    _assert_reports_equal(rep, jrep, clean_block=fault is None)
    if fault != 3:                 # an uncorrectable output is untrusted
        np.testing.assert_allclose(_np(c), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        _np(matmul_kernel(torch.from_numpy(a), torch.from_numpy(b))), a @ b,
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [(1, 2, 1, 32, 32, 16),
                                             (1, 4, 2, 48, 48, 16)])
def test_abft_flash_attention_plain_path_matches_reference(B, H, KV, Sq, Sk,
                                                           hd):
    rs = np.random.RandomState(Sq)
    q, k, v = (rs.randn(*s).astype(np.float32)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    jo, jrep = j_abft_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True, block_q=16,
                                      block_k=16, interpret=True)
    before = kab.flash_ck_launch_count.n
    o, rep = abft_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    assert kab.flash_ck_launch_count.n == before
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=2e-5, rtol=0)
    _assert_reports_equal(rep, jrep, clean_block=True)
    assert not bool(rep.detected)


def _qkv():
    rs = np.random.RandomState(11)
    return (rs.randn(1, 2, 32, 16).astype(np.float32),
            rs.randn(1, 1, 32, 16).astype(np.float32),
            rs.randn(1, 1, 32, 16).astype(np.float32))


def test_abft_attention_pv_corruption_detected_uncorrectable():
    q, k, v = _qkv()
    jinj, inj = _fault_pair(bit=23)
    _, jrep = j_abft_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, block_q=16,
                                     block_k=16, inject=jinj, interpret=True)
    _, rep = abft_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True, inject=inj)
    assert bool(rep.detected) and bool(rep.uncorrectable)
    _assert_reports_equal(rep, jrep)


@pytest.mark.parametrize("causal,bit", [(True, None), (False, None),
                                       (True, 23)])
def test_abft_attention_ref_matches_reference(causal, bit):
    """The checksummed attention oracle (K4's plain version): outputs and
    reports equal the reference's, clean and with a PV-output fault."""
    q, k, v = _qkv()
    jinj = inj = None
    if bit is not None:
        jinj, inj = _fault_pair(bit=bit)
    jo, jrep = j_abft_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, inject=jinj)
    o, rep = abft_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal, inject=inj)
    assert bool(rep.detected) == (bit is not None)
    _assert_reports_equal(rep, jrep, clean_block=bit is None)
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=2e-5, rtol=0)


def test_abft_attention_qk_corruption_escapes():
    q, k, v = _qkv()
    jq = j_flip_bit(jnp.asarray(q), 55, 22)
    jo, jrep = j_abft_flash_attention(jq, jnp.asarray(k), jnp.asarray(v),
                                      causal=True, block_q=16, block_k=16,
                                      interpret=True)
    clean, _ = abft_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True)
    o, rep = abft_flash_attention(flip_bit(torch.from_numpy(q), 55, 22),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  causal=True)
    assert not bool(rep.detected) and not bool(jrep.detected)
    assert not np.allclose(_np(o), _np(clean), atol=1e-5)
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=2e-5, rtol=0)


def test_abft_campaign_matches_reference_row_by_row():
    rows = run_abft_campaign()
    assert len(rows) == 12 and all(r["match"] for r in rows), rows
    assert rows == j_run_abft_campaign()
    # the same campaign through the K3 wrapper (its plain version here)
    assert run_abft_campaign(matmul=abft_matmul) == rows


# -- executor x engine x recovery: the reference's toy workload ---------------

W_NP = np.random.RandomState(7).randn(16, 16).astype(np.float32) * 0.01
SPEC1 = dict(leaf_idx=0, flat_idx=37, bit=21, step=4, target="kernel",
             dtype="float32")
SPEC3 = dict(SPEC1, n_elems=3)


def _jengine(workdir, backend, spec, retry):
    """The reference's test_abft.py engine at level 1 (SafeStop), or with
    RetryRecovery."""
    W = jnp.asarray(W_NP)
    jspec = JSpec(**spec) if spec else None

    def step_fn(state, batch, replica_id, armed):
        inj = (j_make_kernel_fault(jspec, step=state["step"], armed=armed)
               if jspec is not None else None)
        delta, report = j_abft_matmul_ref(state["x"], W, inject=inj)
        fp = jfp.pytree_fingerprint_fused({"d": delta})
        cand = {"x": state["x"] + 0.1 * batch - delta,
                "step": state["step"] + 1}
        return cand, fp, jnp.sum(cand["x"]), report

    sedar = JSedarConfig(level=1, replication=backend, validate_interval=1,
                         param_validate_interval=4, checkpoint_interval=3,
                         checkpoint_dir=os.path.join(workdir, "ckpt"))
    eng = jmake_engine(
        sedar, backend=backend, workdir=workdir,
        schedule=JSchedule(commit_interval=1, validate_interval=4,
                           checkpoint_interval=3),
        step_fn=jax.jit(step_fn),
        state_fp_fn=jax.jit(lambda s: jfp.pytree_fingerprint({"x": s["x"]})),
        fast_state_fp_fn=jax.jit(
            lambda s: jfp.pytree_fingerprint_fused({"x": s["x"]})),
        inj_spec=jspec, inj_flag=JFlag(),
        recovery=JRetry(max_retries=4) if retry else None,
        init_fn=lambda: eng.executor.init_dual(
            {"x": jnp.ones((16, 16), jnp.float32),
             "step": jnp.zeros((), jnp.int32)}),
        notify=lambda e: None)
    return eng


def _tengine(backend, spec, retry):
    """The same workload in the port, its update through the K3 wrapper."""
    W = torch.from_numpy(W_NP)
    tspec = InjectionSpec(**spec) if spec else None

    def step_fn(state, batch, replica_id, armed):
        inj = (make_kernel_fault(tspec, step=state["step"], armed=armed)
               if tspec is not None else None)
        delta, report = abft_matmul(state["x"], W, inject=inj)
        fp = tfp.pytree_fingerprint_fused({"d": delta})
        cand = {"x": state["x"] + 0.1 * batch - delta,
                "step": state["step"] + 1}
        return cand, fp, cand["x"].sum(), report

    return make_engine(
        SedarConfig(), backend=backend, step_fn=step_fn,
        state_fp_fn=lambda s: tfp.pytree_fingerprint_fused({"x": s["x"]}),
        schedule=BoundarySchedule(commit_interval=1, validate_interval=4),
        recovery=(RetryRecovery(max_retries=4) if retry
                  else SafeStop(notify=lambda e: None)),
        inj_spec=tspec, inj_flag=MemoryInjectionFlag(),
        notify=lambda e: None)


def _drive(eng, step_of, batch_of, flip, init, safe_stop, num_steps=8,
           corrupt_at=None):
    """test_abft.py's `_drive` loop, for either package."""
    dual = init()
    eng.reset()
    corrupted = stopped = False
    for _ in range(60):
        step = step_of(dual)
        if step >= num_steps:
            break
        outcome = eng.run_protected_step(dual, batch_of(step), step)
        dual = outcome.dual
        if outcome.event is not None:
            try:
                dual = eng.on_detection(outcome.event, dual)
            except safe_stop:
                stopped = True
                break
            continue
        if corrupt_at is not None and not corrupted and \
                step_of(dual) == corrupt_at:
            corrupted = True       # silent at-rest corruption between steps
            dual = {"r0": dict(dual["r0"], x=flip(dual["r0"]["x"], 5, 20))}
    else:
        raise AssertionError("engine did not converge")
    events = [(e.step, e.boundary, e.effect,
               bool(e.detail.get("abft_corrected"))) for e in eng.detections]
    recs = [(r["kind"], r["step"], r["rollbacks"], r["at"])
            for r in eng.recoveries]
    return _np(dual["r0"]["x"]), stopped, events, recs


def _run_pair(tmp_path, backend, spec=None, retry=False, corrupt_at=None):
    jeng = _jengine(str(tmp_path), backend, spec, retry)
    want = _drive(jeng, lambda d: int(np.asarray(d["r0"]["step"])),
                  lambda s: jnp.full((16, 16), float(s + 1), jnp.float32),
                  j_flip_bit, jeng.init_dual, JSafeStop,
                  corrupt_at=corrupt_at)
    teng = _tengine(backend, spec, retry)
    with hostsync.count_transfers() as st:
        got = _drive(teng, lambda d: d["r0"]["step"],
                     lambda s: torch.full((16, 16), float(s + 1)), flip_bit,
                     lambda: teng.executor.init_dual(
                         {"x": torch.ones((16, 16)), "step": 0}),
                     SedarSafeStop, corrupt_at=corrupt_at)
    return got, want, st


# backend, spec, retry, corrupt_at, expected (events, recovery kinds,
# stopped, verdict reads = executed steps, entry-check reads)
ENGINE_CASES = {
    "l1_stop_on_uncorrectable": (
        "abft", SPEC3, False, None,
        ([(4, "commit", "TDC", False)], ["stop"], True, 5, None)),
    "retry_uncorrectable": (
        "abft", SPEC3, True, None,
        ([(4, "commit", "TDC", False)], ["retry"], False, 9, None)),
    "forward_correction": (
        "abft", SPEC1, False, None,
        ([(4, "commit", "TDC", True)], ["abft_correct"], False, 8, None)),
    "hybrid_catches_at_rest": (
        "hybrid", None, False, 4,
        ([(4, "validate", "FSC", False)], ["stop"], True, 4, 1)),
    "pure_abft_misses_at_rest": (
        "abft", None, False, 4, ([], [], False, 8, None)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_event_streams_match_reference(tmp_path, case):
    backend, spec, retry, corrupt_at, (events, kinds, stopped, verdicts,
                                        entry_checks) = ENGINE_CASES[case]
    got, want, st = _run_pair(tmp_path, backend, spec, retry, corrupt_at)
    x, t_stopped, t_events, t_recs = got
    jx, j_stopped, j_events, j_recs = want
    assert t_events == j_events == events
    assert t_recs == j_recs and [r[0] for r in t_recs] == kinds
    assert t_stopped == j_stopped == stopped
    np.testing.assert_allclose(x, jx, rtol=1e-5, atol=1e-5)
    # one verdict read per executed step; hybrid adds its entry checks
    assert st.by_label.get("abft_verdict") == verdicts
    assert st.by_label.get("state_validate") == entry_checks


def test_forward_correction_and_retry_end_bitwise_equal_to_clean(tmp_path):
    """A corrected step commits forward and a retried one re-executes
    clean: both runs end bit for bit where a clean run ends."""
    clean = _run_pair(tmp_path / "c", "abft")[0][0]
    fixed = _run_pair(tmp_path / "f", "abft", SPEC1)[0]
    retried = _run_pair(tmp_path / "r", "abft", SPEC3, retry=True)[0]
    assert fixed[3] == [("abft_correct", None, 0, 4)]
    assert retried[3] == [("retry", None, 1, 4)]
    np.testing.assert_array_equal(fixed[0], clean)
    np.testing.assert_array_equal(retried[0], clean)


def test_three_tuple_step_fn_matches_reference():
    """The replica backends' 3-tuple step_fn runs unmodified under abft."""

    def jstep(state, batch, replica_id, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        cand = {"x": state["x"] + delta, "step": state["step"] + 1}
        return cand, jfp.pytree_fingerprint_fused({"d": delta}), None

    def tstep(state, batch, replica_id, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        cand = {"x": state["x"] + delta, "step": state["step"] + 1}
        return cand, tfp.pytree_fingerprint_fused({"d": delta}), None

    jex = JAbftExecutor(jstep, lambda s: jfp.pytree_fingerprint(
        {"x": s["x"]}))
    tex = AbftExecutor(tstep, lambda s: tfp.pytree_fingerprint({"x": s["x"]}))
    jd, _, jev = jex.execute(jex.init_dual({"x": jnp.zeros((16, 16)),
                                            "step": jnp.zeros((), jnp.int32)}),
                             jnp.ones((16, 16)), 0, jnp.asarray(False), True)
    with hostsync.count_transfers() as st:
        td, _, tev = tex.execute(tex.init_dual({"x": torch.zeros((16, 16)),
                                                "step": 0}),
                                 torch.ones((16, 16)), 0, False, True)
    assert jev is None and tev is None and st.transfers == 0
    assert td["r0"]["step"] == int(np.asarray(jd["r0"]["step"])) == 1
    np.testing.assert_allclose(_np(td["r0"]["x"]), np.asarray(jd["r0"]["x"]))


@pytest.mark.parametrize("backend", ["abft", "hybrid"])
def test_final_validation_and_external_update_match_reference(tmp_path,
                                                               backend):
    """The end-of-run comparison (paper Sec. 3.1): hybrid compares the idle
    state with its last commit fingerprint and tags the event 'final'; pure
    abft has nothing to compare. A caller's own state update
    (`note_external_update`) drops the baseline instead."""
    jeng = _jengine(str(tmp_path), backend, None, False)
    teng = _tengine(backend, None, False)
    jdual = _drive(jeng, lambda d: int(np.asarray(d["r0"]["step"])),
                   lambda s: jnp.full((16, 16), float(s + 1), jnp.float32),
                   j_flip_bit, jeng.init_dual, JSafeStop)
    tdual = _drive(teng, lambda d: d["r0"]["step"],
                   lambda s: torch.full((16, 16), float(s + 1)), flip_bit,
                   lambda: teng.executor.init_dual(
                       {"x": torch.ones((16, 16)), "step": 0}), SedarSafeStop)
    assert tdual[2] == jdual[2] == []
    jfinal = jeng.validate_final(
        {"r0": {"x": j_flip_bit(jnp.asarray(jdual[0]), 5, 20),
                "step": jnp.asarray(8, jnp.int32)}}, 8)
    corrupt = {"r0": {"x": flip_bit(torch.from_numpy(tdual[0]), 5, 20),
                      "step": 8}}
    tfinal = teng.validate_final(corrupt, 8)
    want = [(8, "final", "FSC")] if backend == "hybrid" else []
    assert [(e.step, e.boundary, e.effect) for e in (tfinal, jfinal)
            if e is not None] == want * 2
    teng.executor.note_external_update()
    assert teng.validate_final(corrupt, 8) is None

