"""The port's 64-scenario replica campaign (`core/scenarios.py`, paper
Sec. 4.1, Table 2) against the JAX package's `run_campaign`, on the CPU:
every row (scenario, prediction, observation, match) equal, row for row;
the paper's exemplars of `tests/test_scenarios.py` as cases of one test;
the send validation through the port's fingerprints with one counted host
read per check; the result check's f32 error bound."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.scenarios import MatmulTestApp as JApp
from repro.core.scenarios import all_scenarios as jall_scenarios
from repro.core.scenarios import predict as jpredict
from repro.core.scenarios import run_campaign as jrun_campaign

from repro_torch.core import hostsync
from repro_torch.core.scenarios import (CKPT_EVENTS, DATA, EVENTS,
                                        PROCESSES, WINDOWS, MatmulTestApp,
                                        Observation, all_scenarios,
                                        campaign_row, predict, run_campaign)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rows():
    return {"jax": jrun_campaign(), "torch": run_campaign(device="cpu")}


def test_constants_equal_jax():
    from repro.core import scenarios as js
    assert (EVENTS, CKPT_EVENTS, WINDOWS, DATA, PROCESSES) == \
        (js.EVENTS, js.CKPT_EVENTS, js.WINDOWS, js.DATA, js.PROCESSES)


def test_64_scenarios_equal_jax():
    ss = all_scenarios()
    assert len(ss) == 64
    assert [dataclasses.astuple(s) for s in ss] == \
        [dataclasses.astuple(s) for s in jall_scenarios()]


def test_predictions_equal_jax():
    for s, js in zip(all_scenarios(), jall_scenarios()):
        assert dataclasses.asdict(predict(s)) == \
            dataclasses.asdict(jpredict(js))


@pytest.mark.parametrize("sid", range(1, 65))
def test_campaign_row_equals_jax(rows, sid):
    t, j = rows["torch"][sid - 1], rows["jax"][sid - 1]
    assert t == j
    assert t["sid"] == sid and t["match"]


def test_full_campaign_matches_predict(rows):
    assert rows["torch"] == rows["jax"]
    assert all(r["match"] for r in rows["torch"])
    effects = {r["obs"]["effect"] for r in rows["torch"]}
    assert effects == {"TDC", "FSC", "LE", "TOE"}


# the paper's exemplars (scenarios 2, 29, 50, 59 analogues) and the
# 3-rollback worker-A scenario, as in tests/test_scenarios.py
@pytest.mark.parametrize("window,proc,datum,effect,p_det,p_rec,n_roll", [
    ("CK0", "M", "A", "TDC", "SCATTER", "CK0", 1),
    ("BCAST", "W", "C", "LE", None, None, 0),
    ("GATHER", "M", "C", "FSC", "VALIDATE", "CK2", 2),
    ("CK2", "W", "i", "TOE", "GATHER", "CK2", 1),
    ("SCATTER", "W", "A", "TDC", "GATHER", "CK0", 3),
])
def test_exemplar_scenarios(window, proc, datum, effect, p_det, p_rec,
                            n_roll):
    s = next(x for x in all_scenarios()
             if (x.window, x.process, x.datum) == (window, proc, datum))
    pred = predict(s)
    assert (pred.effect, pred.p_det, pred.p_rec, pred.n_roll) == \
        (effect, p_det, p_rec, n_roll)
    obs = MatmulTestApp(device="cpu").run(s)
    assert obs.correct_result
    assert (obs.effect, obs.p_det, obs.p_rec, obs.n_roll) == \
        (effect, p_det, p_rec, n_roll)
    jobs = JApp().run(next(x for x in jall_scenarios() if x.sid == s.sid))
    assert dataclasses.asdict(obs) == dataclasses.asdict(jobs)


def test_clean_run_correct_and_reads_one_compare_per_send():
    """A clean run validates SCATTER, BCAST, one GATHER per worker and the
    final VALIDATE: one counted read each, and one per replica's result
    check."""
    app = MatmulTestApp(device="cpu")
    with hostsync.count_transfers() as st:
        obs = app.run(None)
    assert obs.correct_result and obs.n_roll == 0 and obs.p_det is None
    assert st.by_label == {"campaign_validate": 3 + app.workers,
                           "campaign_check": 2}


def test_recovered_runs_end_bitwise_equal_to_the_clean_run():
    app = MatmulTestApp(n=16, workers=4, device="cpu")
    app.run(None)
    clean = [m["M.C"].clone() for m in app.last_mem]
    for s in all_scenarios():
        row = campaign_row(s, app.run(s))
        assert row["match"], row
        assert all(torch.equal(m["M.C"], c)
                   for m, c in zip(app.last_mem, clean))


def test_result_check_holds_the_f32_error_bound():
    """The truth is the f64 product and each element may differ by
    1e-4 + gamma_n (|A| @ |B|): a correct f32 product passes at a size
    where the reference's fixed atol would not hold in general, a flipped
    bit 22 does not."""
    n = 256
    app = MatmulTestApp(n=n, device="cpu")
    c = app.A0 @ app.B0
    assert app._correct(c)
    bad = c.clone()
    bad.view(-1)[3:4].view(torch.int32).bitwise_xor_(1 << 22)
    assert not app._correct(bad)
    u = 2.0 ** -24
    assert float(app.tol.min()) >= 1e-4
    assert float((app.tol - 1e-4).max()) <= n * u / (1 - n * u) * float(
        (app.A0.abs() @ app.B0.abs()).max()) * (1 + 1e-6)


def test_flip_is_the_references():
    """Element min(3, size - 1), bit 22, on replica 1's copy."""
    from repro_torch.core.scenarios import _flip
    x = torch.arange(8, dtype=torch.float32)
    _flip(x, 22)
    want = np.arange(8, dtype=np.float32)
    want[3:4].view(np.uint32)[0] ^= np.uint32(1 << 22)
    assert np.array_equal(x.numpy(), want)
    y = torch.zeros((), dtype=torch.float32)
    _flip(y, 22)
    assert y.view(torch.int32).item() == 1 << 22


def test_observation_fields_equal_jax():
    from repro.core.scenarios import Observation as JObservation
    assert [f.name for f in dataclasses.fields(Observation)] == \
        [f.name for f in dataclasses.fields(JObservation)]


def test_campaign_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the campaign would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MatmulTestApp()
