"""The slice as a whole: the port's protected `generate()` against the JAX
reference's, on the same seeded prompt and the same params (carried across
by `bridge.params_from_numpy`), at reduce_for_smoke(qwen2-0.5b).

Held exactly: the emitted tokens, and the (step, boundary, effect) stream
of detections with its retries and safe stop under the same
`InjectionSpec`."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.serve import SedarServer as JServer

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import RunConfig, TrainConfig, get_config, \
    reduce_for_smoke
from repro_torch.core import hostsync
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_server
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import flash_attention as kfa

torch.set_num_threads(1)

STEPS = 6
SPEC = dict(leaf_idx=2, flat_idx=3, bit=30, step=10, replica=1,
            target="params")       # layers/attn/bk, fires at pos 10


def _cfgs(impl="xla"):
    return (dataclasses.replace(jreduce(jget_config("qwen2-0.5b")),
                                attention_impl=impl),
            dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                                attention_impl=impl))


@pytest.fixture(scope="module")
def shared():
    jcfg, _ = _cfgs()
    srv = JServer(JRunConfig(model=jcfg, train=JTrainConfig(global_batch=2,
                                                            seq_len=8)))
    jparams = srv.model.init(jax.random.PRNGKey(0))
    prompt = np.random.RandomState(0).randint(0, 200, (2, 8)).astype(np.int32)
    clean, _ = srv.generate(jparams, {"tokens": prompt}, steps=STEPS)
    return {"jparams": jparams, "prompt": prompt, "clean": clean,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams))}


def _port(dual=False, inj=None, impl="xla", **kw):
    _, tcfg = _cfgs(impl)
    return make_server(RunConfig(model=tcfg, train=TrainConfig(
        global_batch=2, seq_len=8)), dual=dual, inj_spec=inj, device="cpu",
        **kw)


def _events(rep):
    return [(e.step, e.boundary, e.effect) for e in rep.detections]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dual_generate_matches_reference_tokens(shared, impl):
    srv = _port(dual=True, impl=impl)
    with hostsync.count_transfers() as st:
        toks, rep = srv.generate(shared["tparams"],
                                 {"tokens": shared["prompt"]}, steps=STEPS)
    np.testing.assert_array_equal(toks, shared["clean"])
    assert not rep.detections and not rep.stopped
    assert rep.tokens_emitted == 2 * STEPS
    # one commit compare and one token read per decode step, one first token
    assert st.by_label == {"commit_compare": STEPS - 1, "token_emit": STEPS}


def test_transient_fault_detects_retries_and_matches_reference(shared):
    jcfg, _ = _cfgs()
    jsrv = JServer(JRunConfig(model=jcfg, train=JTrainConfig(
        global_batch=2, seq_len=8)), dual=True, inj_spec=JSpec(**SPEC))
    jtoks, jrep = jsrv.generate(shared["jparams"],
                                {"tokens": shared["prompt"]}, steps=STEPS)
    srv = _port(dual=True, inj=InjectionSpec(**SPEC))
    toks, rep = srv.generate(shared["tparams"], {"tokens": shared["prompt"]},
                             steps=STEPS)
    assert _events(rep) == _events(jrep) == [(10, "commit", "TDC")]
    assert rep.retries == jrep.retries == 1
    np.testing.assert_array_equal(toks, shared["clean"])
    np.testing.assert_array_equal(jtoks, shared["clean"])
    assert srv.engine.recoveries == [
        {"kind": r["kind"], "step": r["step"], "rollbacks": r["rollbacks"],
         "at": r["at"]} for r in jsrv.engine.recoveries]
    # localization: the corrupted K bias shows up in the replica's KV cache
    leaves = {m["leaf"] for m in rep.detections[0].detail["mismatch"]}
    assert "['cache']['k']" in leaves


def test_persistent_fault_exhausts_retries_into_safe_stop(shared):
    spec = dict(SPEC, persistent=True)
    jcfg, _ = _cfgs()
    jsrv = JServer(JRunConfig(model=jcfg, train=JTrainConfig(
        global_batch=2, seq_len=8)), dual=True, inj_spec=JSpec(**spec),
        max_retries=2)
    jtoks, jrep = jsrv.generate(shared["jparams"],
                                {"tokens": shared["prompt"]}, steps=STEPS)
    srv = _port(dual=True, inj=InjectionSpec(**spec), max_retries=2)
    toks, rep = srv.generate(shared["tparams"], {"tokens": shared["prompt"]},
                             steps=STEPS)
    assert rep.stopped and jrep.stopped
    assert _events(rep) == _events(jrep) == [(10, "commit", "TDC")] * 3
    assert rep.retries == jrep.retries == 2
    np.testing.assert_array_equal(toks, jtoks)


def test_unprotected_server_and_cpu_launch_counts(shared):
    """backend "none" emits the same tokens; on the CPU no kernel launch is
    counted (the wrappers take the plain versions)."""
    before = (kfp.launch_count.n, kfa.launch_count.n)
    srv = _port(dual=False, impl="pallas")
    toks, rep = srv.generate(shared["tparams"], {"tokens": shared["prompt"]},
                             steps=STEPS)
    np.testing.assert_array_equal(toks, shared["clean"])
    assert srv.engine.executor.name == "none"
    assert (kfp.launch_count.n, kfa.launch_count.n) == before


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(RunConfig(model=_cfgs()[1]), dual=True)

