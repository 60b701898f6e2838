"""Replica-free serving in the port against the JAX reference's, at
reduce_for_smoke(qwen2-0.5b) on the CPU, the same params carried across by
`bridge.params_from_numpy`: `SedarServer(backend="abft"|"hybrid")` tokens,
the kernel-fault forward correction, the counted host reads, the hybrid
entry check after a failed step (the in-place KV cache trap), and the
launcher's `--backend`.

Held exactly: tokens, the (step, boundary, effect, abft_corrected) event
stream and the recovery records."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.serve import SedarServer as JServer

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (RunConfig, SedarConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core import hostsync
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_server

torch.set_num_threads(1)

STEPS = 6
INTERVAL = 2          # hybrid entry checks at positions 10 and 12
V = 257               # reduce_for_smoke vocabulary


def _jserver(backend, spec=None, **kw):
    cfg = jreduce(jget_config("qwen2-0.5b"))
    return JServer(JRunConfig(model=cfg, sedar=JSedarConfig(
        param_validate_interval=INTERVAL)), backend=backend,
        inj_spec=JSpec(**spec) if spec else None, **kw)


def _tserver(backend, spec=None, **kw):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              attention_impl="pallas")
    return make_server(RunConfig(model=cfg, sedar=SedarConfig(
        param_validate_interval=INTERVAL)), backend=backend,
        inj_spec=InjectionSpec(**spec) if spec else None, device="cpu", **kw)


@pytest.fixture(scope="module")
def shared():
    srv = _jserver("none")
    jparams = srv.model.init(jax.random.PRNGKey(0))
    prompt = np.random.RandomState(0).randint(0, 200, (2, 8)).astype(np.int32)
    clean, _ = srv.generate(jparams, {"tokens": prompt}, steps=STEPS)
    return {"jparams": jparams, "prompt": prompt, "clean": clean,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams))}


def _events(rep):
    return [(e.step, e.boundary, e.effect,
             bool(e.detail.get("abft_corrected"))) for e in rep.detections]


def _recs(eng):
    return [(r["kind"], r["step"], r["rollbacks"], r["at"])
            for r in eng.recoveries]


def _pair(shared, backend, spec=None, **kw):
    """(port tokens, report, host reads, server), (JAX tokens, report,
    server) of one generate under the same backend and spec."""
    jsrv = _jserver(backend, spec, **kw)
    jtoks, jrep = jsrv.generate(shared["jparams"],
                                {"tokens": shared["prompt"]}, steps=STEPS)
    srv = _tserver(backend, spec, **kw)
    with hostsync.count_transfers() as st:
        toks, rep = srv.generate(shared["tparams"],
                                 {"tokens": shared["prompt"]}, steps=STEPS)
    return (toks, rep, st, srv), (jtoks, jrep, jsrv)


@pytest.mark.parametrize("backend,entry_checks", [("abft", 0), ("hybrid", 2)])
def test_clean_replica_free_generate_matches_reference(shared, backend,
                                                       entry_checks):
    (toks, rep, st, srv), (jtoks, jrep, _) = _pair(shared, backend)
    np.testing.assert_array_equal(jtoks, shared["clean"])
    np.testing.assert_array_equal(toks, shared["clean"])
    assert not rep.detections and not jrep.detections and not rep.stopped
    assert srv.engine.executor.name == backend
    # one verdict read per decode step, one token read per token, and
    # hybrid's entry checks at its cadence
    want = {"abft_verdict": STEPS - 1, "token_emit": STEPS}
    if entry_checks:
        want["state_validate"] = entry_checks
    assert st.by_label == want
    plain, _ = _tserver("none").generate(
        shared["tparams"], {"tokens": shared["prompt"]}, steps=STEPS)
    np.testing.assert_array_equal(plain, toks)


@pytest.mark.parametrize("backend", ["abft", "hybrid"])
def test_kernel_fault_corrected_forward_like_reference(shared, backend):
    """test_serve_batched.py's generate case: a bit-30 flip in the logits
    checksum block is corrected in place and the corrected commit emits
    its token — no retry, no re-execution, unchanged tokens."""
    spec = dict(leaf_idx=0, flat_idx=1 * (V + 1) + 5, bit=30, step=10,
                replica=0, target="kernel")
    (toks, rep, st, srv), (jtoks, jrep, jsrv) = _pair(shared, backend, spec)
    assert _events(rep) == _events(jrep) == [(10, "commit", "TDC", True)]
    assert _recs(srv.engine) == _recs(jsrv.engine) == \
        [("abft_correct", None, 0, 10)]
    assert rep.retries == jrep.retries == 0 and not rep.stopped
    np.testing.assert_array_equal(toks, shared["clean"])
    np.testing.assert_array_equal(jtoks, shared["clean"])
    assert st.by_label["abft_verdict"] == STEPS - 1
    assert st.by_label["token_emit"] == STEPS


UNCORRECTABLE = dict(leaf_idx=0, flat_idx=3, bit=30, step=10, replica=0,
                     target="kernel", n_elems=3)


def test_hybrid_retry_at_an_entry_check_step_matches_reference(shared):
    """An uncorrectable fault at position 10, where hybrid's entry check is
    due: the step is retried and the retry's entry check passes, as in the
    reference (whose cache is functional)."""
    (toks, rep, st, srv), (jtoks, jrep, jsrv) = _pair(
        shared, "hybrid", UNCORRECTABLE)
    assert _events(rep) == _events(jrep) == [(10, "commit", "TDC", False)]
    assert _recs(srv.engine) == _recs(jsrv.engine) == [("retry", None, 1, 10)]
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(toks, shared["clean"])
    # entry checks at 10 (twice: the failed attempt and the retry) and 12
    assert st.by_label["state_validate"] == 3


def test_whole_cache_baseline_would_flag_the_failed_steps_own_write(shared):
    """The trap the baseline avoids: the failed attempt at position 10 has
    already written cache row 10 in place, so a fingerprint over the WHOLE
    cache no longer matches the last commit's at the retry's entry check —
    a false FSC detection the reference never reports."""
    srv = _tserver("hybrid", UNCORRECTABLE, max_retries=2)
    srv._fp_tree = lambda s: {"cache": s["cache"], "tok": s["tok"]}
    _, rep = srv.generate(shared["tparams"], {"tokens": shared["prompt"]},
                          steps=STEPS)
    assert _events(rep)[:2] == [(10, "commit", "TDC", False),
                                (10, "validate", "FSC", False)]


def test_launcher_backend_abft_runs_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr("sys.argv", ["serve", "--backend", "abft", "--device",
                                     "cpu", "--batch", "2", "--steps", "4"])
    launcher.main()
    out = capsys.readouterr().out
    assert "backend=abft" in out and "detections=0" in out


def test_unported_backends_and_targets_raise():
    """The mesh backends are not ported; `fused` and the `prefill_kernel`
    target are."""
    for backend in ("pod", "vote"):
        with pytest.raises(NotImplementedError, match=f"backend '{backend}'"):
            _tserver(backend)
    assert _tserver("fused").engine.executor.name == "fused"
    srv = _tserver("abft", dict(leaf_idx=0, flat_idx=0, bit=1, step=0,
                                target="prefill_kernel"))
    assert srv.prefiller.guarded
