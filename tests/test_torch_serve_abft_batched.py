"""Replica-free continuous serving (`serve()` under abft/hybrid) in the port
against the JAX reference's, at reduce_for_smoke(qwen2-0.5b) in f32 on the
CPU, the same params carried across by `bridge.params_from_numpy` and the
same `synthetic_requests`.

Held exactly: each request's tokens, the counters and each event's (step,
boundary, effect, slots, abft_corrected) — the decode checksum guard's
forward correction, the packed admission's `pack_checksum_guard` (a
corrected pack admitted, an uncorrectable fault localized to its rows, a
hybrid clean run) and the abft drain case. Then what only the port has:
hybrid's per-slot resident baseline (rows [0, pos[i]) through K1's
row-limit leaves): no false FSC around a retried step, an at-rest fault
in a row a slot attends to flagged, one at row pos[i] (overwritten before
any read) ignored where a whole-cache fingerprint would flag it; the plain
row-limit fingerprint against a masked copy; and the continuous launcher's
default (`sequential`, not unprotected)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.abft.executor import pack_checksum_guard as jpack_guard
from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import synthetic_requests as jsynthetic
from repro.runtime.serve import SedarServer as JServer

from repro_torch.abft.executor import pack_checksum_guard
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.core import hostsync
from repro_torch.core.fingerprint import (pack_tree_u32,
                                          pytree_fingerprint_fused,
                                          slot_rows_fingerprint)
from repro_torch.core.injection import InjectionSpec
from repro_torch.kernels import fingerprint as kfp
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.scheduler import Request, synthetic_requests
from repro_torch.runtime.serve import SedarServer

torch.set_num_threads(1)

SLOTS = 3
FAULT_SLOT = 1
INTERVAL = 2          # hybrid's entry check every other tick
V = 257               # reduce_for_smoke vocabulary
COUNTERS = ("completed", "rejected", "retries", "rollbacks",
            "truncated_tokens", "prefill_packs", "prefill_retries", "steps")


def _rc():
    return RunConfig(model=reduce_for_smoke(get_config("qwen2-0.5b")),
                     train=TrainConfig(global_batch=2, seq_len=8),
                     sedar=SedarConfig(param_validate_interval=INTERVAL))


def _jrc():
    return JRunConfig(model=jreduce(jget_config("qwen2-0.5b")),
                      train=JTrainConfig(global_batch=2, seq_len=8),
                      sedar=JSedarConfig(param_validate_interval=INTERVAL))


def _requests(mod):
    return mod(5, arrival_rate=2.0, prompt_lengths=(4, 8),
               max_new_choices=(4, 8), seed=1)


def _pack_requests(cls):
    """tests/test_prefill.py's traffic: lens 4, 6 -> one bucket-8 pack of
    2, len 9 -> a bucket-16 pack of 1, all at t=0."""
    return [cls(rid=i, prompt=np.arange(1, ln + 1, dtype=np.int32),
                max_new_tokens=4, arrival=0)
            for i, ln in enumerate((4, 6, 9))]


WORKLOADS = {
    "default": (lambda: _requests(jsynthetic),
                lambda: _requests(synthetic_requests)),
    "packs": (lambda: _pack_requests(JRequest),
              lambda: _pack_requests(Request)),
}


@pytest.fixture(scope="module")
def shared():
    jsrv = JServer(_jrc(), dual=True)
    jparams = jsrv.model.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    srv = SedarServer(_rc(), dual=True, device="cpu")
    clean = {}
    for wl, (_, treqs) in WORKLOADS.items():
        reqs, rep = srv.serve(tparams, treqs(), slots=SLOTS, validate_lag=1)
        assert not rep.detections
        clean[wl] = {r.rid: list(r.tokens) for r in reqs}
    return {"jparams": jparams, "tparams": tparams, "clean": clean}


def _events(rep):
    return [(e.step, e.boundary, e.effect, e.detail.get("slots"),
             bool(e.detail.get("abft_corrected"))) for e in rep.detections]


def _kinds(srv):
    eng = srv._batch_engines[next(iter(srv._batch_engines))][0]
    return [r["kind"] for r in eng.recoveries]


def _both(shared, backend, spec=None, workload="default", **kw):
    jreqs_fn, treqs_fn = WORKLOADS[workload]
    jsrv = JServer(_jrc(), backend=backend,
                   inj_spec=JSpec(**spec) if spec else None)
    jreqs, jrep = jsrv.serve(shared["jparams"], jreqs_fn(), slots=SLOTS,
                             **kw)
    srv = SedarServer(_rc(), backend=backend,
                      inj_spec=InjectionSpec(**spec) if spec else None,
                      device="cpu")
    with hostsync.count_transfers() as st:
        treqs, trep = srv.serve(shared["tparams"], treqs_fn(), slots=SLOTS,
                                **kw)
    return (jreqs, jrep, jsrv), (treqs, trep, srv, st)


def _kernel_fault(step=3, n_elems=1, slot=FAULT_SLOT):
    return dict(leaf_idx=0, flat_idx=slot * (V + 1) + 5, bit=30, step=step,
                replica=0, target="kernel", n_elems=n_elems)


PACK_KERNEL = dict(leaf_idx=0, flat_idx=5, bit=30, step=0, replica=0,
                   target="prefill_kernel")

# (backend, spec, workload, serve kwargs, expected events)
CASES = {
    # test_serve_batched.py: the decode guard corrects forward and emits
    "abft_decode_corrected": ("abft", _kernel_fault(), "default", {},
                              [(3, "commit", "TDC", None, True)]),
    "hybrid_decode_corrected": ("hybrid", _kernel_fault(), "default", {},
                                [(3, "commit", "TDC", None, True)]),
    "abft_decode_uncorrectable": ("abft", _kernel_fault(n_elems=3),
                                  "default", {},
                                  [(3, "commit", "TDC", None, False)]),
    "abft_clean": ("abft", None, "default", {}, []),
    "hybrid_clean": ("hybrid", None, "default", {}, []),
    # test_emission.py: abft under drain (the lag clamps to 1)
    "abft_drain_lag4": ("abft", _kernel_fault(), "default",
                        dict(validate_lag=4),
                        [(3, "commit", "TDC", None, True)]),
    # test_prefill.py: packed admission's checksum guard
    "abft_pack_corrected": ("abft", PACK_KERNEL, "packs", {},
                            [(0, "prefill", "abft_corrected", [0, 1],
                              False)]),
    "abft_pack_uncorrectable": ("abft", dict(PACK_KERNEL, n_elems=2),
                                "packs", {}, None),
    "hybrid_packs_clean": ("hybrid", None, "packs", {}, []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replica_free_serve_matches_reference(shared, case):
    backend, spec, workload, kw, want_events = CASES[case]
    (jreqs, jrep, jsrv), (treqs, trep, srv, st) = _both(
        shared, backend, spec, workload, **kw)
    assert _events(trep) == _events(jrep)
    if want_events is not None:
        assert _events(trep) == want_events
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    for j, t in zip(jreqs, treqs):
        assert list(t.tokens) == list(j.tokens), t.rid
        assert t.status == j.status == "done", t.rid
        assert list(t.tokens) == shared["clean"][workload][t.rid], t.rid
    jeng = jsrv._batch_engines[next(iter(jsrv._batch_engines))][0]
    assert _kinds(srv) == [r["kind"] for r in jeng.recoveries]
    assert trep.rollbacks == 0 and not trep.stopped
    assert "commit_compare" not in st.by_label
    assert st.by_label["abft_verdict"] == trep.steps


def test_pack_uncorrectable_is_localized_to_rows(shared):
    """Two corrupted elements defeat single-element correction: only the
    rows whose residuals are violated retry, and the retry (disarmed)
    admits them."""
    _, (treqs, trep, _, _) = _both(shared, "abft", dict(PACK_KERNEL,
                                                        n_elems=2), "packs")
    tdc = [e for e in trep.detections if e.boundary == "prefill"
           and e.effect == "TDC"]
    assert tdc and len(tdc[0].detail["rids"]) < 3
    assert trep.prefill_retries == len(tdc[0].detail["rids"])


def test_hybrid_entry_checks_run_on_the_clean_serve(shared):
    (_, jrep, _), (treqs, trep, srv, st) = _both(shared, "hybrid")
    assert not trep.detections and not jrep.detections
    assert st.by_label.get("state_validate", 0) > 0
    eng = srv._batch_engines[next(iter(srv._batch_engines))][0]
    assert eng.executor.name == "hybrid"
    assert eng.schedule.validate_interval == INTERVAL


def _entry_check_tick(shared):
    """A tick whose entry check is due and runs in the clean hybrid serve
    (no admission between the previous commit and it)."""
    srv = SedarServer(_rc(), backend="hybrid", device="cpu")
    ticks = []
    orig = srv._batch_engine

    def spy(*a):
        eng, ring, rec = orig(*a)
        ex = eng.executor
        if not getattr(ex, "_spied", False):
            fn = ex._resident_fp_equal

            def logged(dual):
                ticks.append(ex._last_fp_step)
                return fn(dual)
            ex._resident_fp_equal, ex._spied = logged, True
        return eng, ring, rec

    srv._batch_engine = spy
    srv.serve(shared["tparams"], _requests(synthetic_requests), slots=SLOTS)
    assert ticks
    return ticks[len(ticks) // 2]


def test_hybrid_retry_after_an_entry_check_gives_no_fsc(shared):
    """An uncorrectable fault at a tick whose entry check ran: the failed
    attempt writes every slot's row pos[i] in place, and the retry (the
    next tick: serve()'s tick advances on a retry, so the stale baseline
    skips a check there, as in the reference) and every later entry check
    pass. Events, counters and tokens equal the reference's."""
    tick = _entry_check_tick(shared)
    spec = _kernel_fault(step=tick, n_elems=3)
    (jreqs, jrep, _), (treqs, trep, _, st) = _both(shared, "hybrid", spec)
    assert _events(trep) == _events(jrep) == \
        [(tick, "commit", "TDC", None, False)]
    assert trep.retries == jrep.retries == 1
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    for r in treqs:
        assert list(r.tokens) == shared["clean"]["default"][r.rid]
    assert st.by_label["state_validate"] >= 1


def _at_rest_fault(srv, tick, row_offset):
    """Before the protected step at `tick`, add 1 to cache row
    pos[s] + row_offset of the first running slot s, in place (an at-rest
    fault between the last commit and the entry check)."""
    orig = srv._batch_engine

    def wrapped(*a):
        eng, ring, rec = orig(*a)
        ex = eng.executor
        if not getattr(ex, "_wrapped", False):
            run = ex.execute

            def execute(dual, batch, step, armed, compare):
                if step == tick:
                    st = dual["r0"]
                    s = int(torch.nonzero(st["active"])[0, 0])
                    st["cache"]["k"][:, s, int(st["pos"][s]) + row_offset] \
                        += 1.0
                return run(dual, batch, step, armed, compare)
            ex.execute, ex._wrapped = execute, True
        return eng, ring, rec

    srv._batch_engine = wrapped
    _, rep = srv.serve(srv._params, _requests(synthetic_requests),
                       slots=SLOTS)
    return [(e.step, e.boundary, e.effect) for e in rep.detections]


def test_hybrid_baseline_covers_rows_below_pos_only(shared, monkeypatch):
    """The per-slot baseline sees an at-rest fault in a row a slot will
    attend to (row pos[s] - 1: FSC at the entry check) and ignores one at
    row pos[s], which the step overwrites before any read. A fingerprint
    of the WHOLE cache (the reference's tree) would flag the latter: a
    false FSC for a harmless write."""
    tick = _entry_check_tick(shared)

    def run(offset):
        srv = SedarServer(_rc(), backend="hybrid", device="cpu")
        srv._params = shared["tparams"]
        return _at_rest_fault(srv, tick, offset)

    assert run(-1)[:1] == [(tick, "validate", "FSC")]
    assert run(0) == []
    monkeypatch.setattr(
        tserve, "slot_rows_fingerprint",
        lambda cache, pos, tok, **layout: pytree_fingerprint_fused(
            {"cache": cache, "tok": tok}))
    assert run(0)[:1] == [(tick, "validate", "FSC")]


GUARD_SPECS = {
    "clean": None,
    "corrected": dict(PACK_KERNEL, flat_idx=1 * (V + 1) + 9),
    "localized": dict(PACK_KERNEL, flat_idx=1 * (V + 1) + 9, n_elems=2),
    "checksum_row_only": dict(PACK_KERNEL, flat_idx=4 * (V + 1) + 3,
                              n_elems=3),
    "other_target": dict(PACK_KERNEL, target="kernel"),
    "not_armed_step": dict(PACK_KERNEL, step=5),
}


@pytest.mark.parametrize("case", list(GUARD_SPECS))
def test_pack_checksum_guard_matches_reference(case):
    """Verdicts exactly, the verified logits within f32 rounding of the
    reference's, on the same numpy block (K = 4 rows)."""
    r = np.random.RandomState(3)
    lg = (r.standard_normal((4, V)) * 4).astype(np.float32)
    spec = GUARD_SPECS[case]
    jout, jverd, jrep = jpack_guard(
        jnp.asarray(lg), JSpec(**spec) if spec else None, 0, 1)
    out, verd, rep = pack_checksum_guard(
        torch.from_numpy(lg), InjectionSpec(**spec) if spec else None, 0,
        True)
    # a row the fault made non-finite is rejected by the port, where the
    # reference's `|res| > tau` admits its NaN (ROADMAP F3): the
    # checksum_row_only case's flips make element (0, 4) a NaN
    nan_rows = ~np.isfinite(np.asarray(jout)).all(axis=1)
    assert nan_rows.any() == (case == "checksum_row_only")
    np.testing.assert_array_equal(
        verd.numpy(), np.where(nan_rows, 0, np.asarray(jverd)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-5)
    for f in ("detected", "corrected", "uncorrectable"):
        assert bool(getattr(rep, f)) == bool(np.asarray(getattr(jrep, f)))
    want = {"clean": [1] * 4, "corrected": [2] * 4, "other_target": [1] * 4,
            "not_armed_step": [1] * 4}
    if case in want:
        assert verd.tolist() == want[case]
    if case == "localized":
        assert verd.tolist() == [1, 0, 0, 1]


@pytest.mark.parametrize("n_slots", [1, 3])
def test_row_limit_fingerprint_equals_masked_copy(n_slots):
    """K1's plain row-limit leaves: each slot's rows at or past pos[i] hash
    as zero words at their fixed offsets, the same words as a masked copy
    through the existing plain fingerprint (hash words and absmax
    bitwise); no host read of pos."""
    r = np.random.RandomState(n_slots)
    cache = {n: torch.from_numpy(r.standard_normal(
        (2, n_slots, 7, 2, 3)).astype(np.float32)) for n in "vk"}
    pos = torch.tensor([5, 0, 7][:n_slots], dtype=torch.int64)
    tok = torch.arange(n_slots, dtype=torch.int64)[:, None]
    with hostsync.count_transfers() as st:
        got = slot_rows_fingerprint(cache, pos, tok)
    assert st.transfers == 0
    masked = []
    for name in sorted(cache):
        for i in range(n_slots):
            x = cache[name][:, i].clone()
            x[:, int(pos[i]):] = 0
            masked.append(x)
    want = kfp.fingerprint_plain(pack_tree_u32(masked + [tok]))
    assert torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])
    # a row past the limit does not count; a row below it does
    c2 = {n: c.clone() for n, c in cache.items()}
    c2["k"][:, 0, 6] += 1.0
    assert torch.equal(slot_rows_fingerprint(c2, pos, tok)[:2], got[:2])
    c2["k"][:, 0, 4] += 1.0
    assert not torch.equal(slot_rows_fingerprint(c2, pos, tok)[:2], got[:2])
    # an int32 limit element reads the same
    assert torch.equal(slot_rows_fingerprint(cache, pos.to(torch.int32),
                                             tok), got)


def test_row_limit_table_rules():
    c = torch.zeros(2, 3, 7, 2, 3)
    pos = torch.tensor([1, 2, 3])
    table = kfp.leaf_table([c[:, 1]], [(pos[1], 1)])
    assert (table[0].rows, table[0].run, table[0].per_row) == (2, 42, 6)
    assert table[0].limit.data_ptr() == pos[1].data_ptr()
    # a contiguous slot cache (one slot) is cut into one run per layer
    one = torch.zeros(2, 1, 7, 2, 3)
    t1 = kfp.leaf_table([one[:, 0]], [(pos[0], 1)])
    assert (t1[0].rows, t1[0].run, t1[0].stride) == (2, 42, 42)
    assert kfp.leaf_table([c[:, 1]], [(pos[1:], 1)]) is None   # not 0-d
    many = [torch.zeros(3)] * (kfp.MAX_LIMITS + 1)
    lims = [(torch.tensor(i), 0) for i in range(kfp.MAX_LIMITS + 1)]
    assert kfp.leaf_table(many, lims) is None


@pytest.mark.parametrize("backend,expect", [
    (None, ("backend=sequential", "detections=1", "slots=[1]")),
    ("fused", ("backend=fused", "detections=1", "slots=[1]")),
    ("abft", ("backend=abft", "detections=1", "retries=0")),
    ("hybrid", ("backend=hybrid", "detections=1", "retries=0")),
])
def test_continuous_launcher_protects_by_default(monkeypatch, capsys,
                                                 backend, expect):
    """`--continuous --fault-slot 1` without `--dual` serves `sequential`
    and detects the fault (the reference's default); abft/hybrid take a
    kernel-domain fault in the slot's row of the checksummed block and
    correct it forward."""
    from repro_torch.launch import serve as launcher
    argv = ["serve", "--continuous", "--arch", "qwen2-0.5b", "--requests",
            "4", "--fault-slot", "1", "--fault-step", "3", "--device", "cpu"]
    if backend:
        argv += ["--backend", backend]
    monkeypatch.setattr("sys.argv", argv)
    launcher.main()
    out = capsys.readouterr().out
    for e in expect:
        assert e in out, out
    assert "completed=4" in out
