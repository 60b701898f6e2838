"""The port's heartbeats (`repro_torch/runtime/cluster.py`: `HostState`,
`Heartbeat`, `ClusterMonitor`) against the JAX package's, on the cases of
`tests/test_cluster.py`: the port writes the heartbeat files, and the
port's monitor and the reference's read the same directory and report the
same hosts, stale hosts and stragglers (either package reads the other's
files). Also the IO hardening: retried and abandoned beats, corrupted
files and a failing listdir."""
import os
import time

import pytest

from repro.runtime import cluster as jcluster

from repro_torch.runtime import cluster as tcluster
from repro_torch.runtime.cluster import ClusterMonitor, Heartbeat

# name -> (beats {host: step}, n_hosts, monitor kwargs, wait_s,
# expected (seen, stale, stragglers))
CASES = {
    "roundtrip": ({h: 10 + h for h in range(4)}, 4, dict(timeout_s=60), 0,
                  ([0, 1, 2, 3], [], [])),
    "missing_host": ({0: 5, 1: 5, 3: 5}, 4, dict(timeout_s=60), 0,
                     ([0, 1, 3], [2], [])),
    "old_beat": ({0: 5}, 1, dict(timeout_s=0.01), 0.05, ([0], [0], [])),
    "straggler": ({0: 100, 1: 100, 2: 100, 3: 10}, 4, {}, 0,
                  ([0, 1, 2, 3], [], [3])),
    "factor_2_flags_40pct": ({0: 100, 1: 100, 2: 100, 3: 40}, 4,
                             dict(straggler_factor=2.0), 0,
                             ([0, 1, 2, 3], [], [3])),
    "factor_10_tolerates_40pct": ({0: 100, 1: 100, 2: 100, 3: 40}, 4,
                                  dict(straggler_factor=10.0), 0,
                                  ([0, 1, 2, 3], [], [])),
    "factor_2_tolerates_90pct": ({0: 100, 1: 100, 2: 90, 3: 100}, 4,
                                 dict(straggler_factor=2.0), 0,
                                 ([0, 1, 2, 3], [], [])),
    "factor_1_05_flags_90pct": ({0: 100, 1: 100, 2: 90, 3: 100}, 4,
                                dict(straggler_factor=1.05), 0,
                                ([0, 1, 2, 3], [], [2])),
    "grace_floor": ({0: 2, 1: 2, 2: 2, 3: 0}, 4,
                    dict(straggler_factor=2.0), 0, ([0, 1, 2, 3], [], [])),
}


def _view(mod, d, n_hosts, kw):
    mon = mod.ClusterMonitor(d, n_hosts, **kw)
    seen = mon.scan()
    return (sorted(seen), {h: s.step for h, s in seen.items()},
            mon.stale_hosts(), mon.stragglers())


@pytest.mark.parametrize("name", sorted(CASES))
def test_monitor_equal_to_jax(tmp_path, name):
    beats, n_hosts, kw, wait, (seen, stale, strag) = CASES[name]
    d = str(tmp_path)
    for h, step in beats.items():
        assert Heartbeat(d, h).beat(step=step)
    if wait:
        time.sleep(wait)
    got = _view(tcluster, d, n_hosts, kw)
    assert got == _view(jcluster, d, n_hosts, kw)
    assert (got[0], got[2], got[3]) == (seen, stale, strag)
    assert got[1] == beats


def test_reads_the_reference_files(tmp_path):
    d = str(tmp_path)
    for h in range(3):
        jcluster.Heartbeat(d, h).beat(step=7 * h)
    seen = ClusterMonitor(d, 3, timeout_s=60).scan()
    assert {h: (s.host_id, s.step) for h, s in seen.items()} == \
        {0: (0, 0), 1: (1, 7), 2: (2, 14)}
    assert isinstance(seen[0], tcluster.HostState)


def test_stale_hosts_honors_zero_now(tmp_path):
    d = str(tmp_path)
    Heartbeat(d, 0).beat(step=5)
    mon = ClusterMonitor(d, n_hosts=1, timeout_s=0.01)
    time.sleep(0.05)
    assert mon.stale_hosts() == [0]
    assert mon.stale_hosts(now=0.0) == []


def test_heartbeat_retries_transient_io_error(tmp_path, monkeypatch):
    real_replace = os.replace
    fails = {"n": 2}

    def flaky(src, dst):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", flaky)
    hb = Heartbeat(str(tmp_path), 0, retries=3, retry_wait_s=0.0)
    assert hb.beat(step=7) is True
    assert hb.io_errors == 0
    assert ClusterMonitor(str(tmp_path), 1).scan()[0].step == 7


def test_heartbeat_gives_up_without_raising(tmp_path, monkeypatch):
    monkeypatch.setattr(os, "replace",
                        lambda s, d: (_ for _ in ()).throw(OSError("disk")))
    hb = Heartbeat(str(tmp_path), 0, retries=2, retry_wait_s=0.0)
    assert hb.beat(step=1) is False
    assert hb.io_errors == 1
    assert ClusterMonitor(str(tmp_path), 1, timeout_s=60).stale_hosts() \
        == [0]


def test_scan_skips_corrupted_heartbeats(tmp_path):
    d = str(tmp_path)
    Heartbeat(d, 0).beat(step=9)
    for h, text in ((1, "not json at all \x00\xff"),
                    (2, '{"host": 2, "step": '),
                    (3, '[1, 2, 3]')):
        with open(os.path.join(d, f"host_{h:05d}.json"), "w") as f:
            f.write(text)
    got = _view(tcluster, d, 4, dict(timeout_s=60))
    assert got == _view(jcluster, d, 4, dict(timeout_s=60))
    assert got[0] == [0] and got[1] == {0: 9} and got[2] == [1, 2, 3]


def test_scan_survives_listdir_failure(tmp_path, monkeypatch):
    d = str(tmp_path)
    Heartbeat(d, 0).beat(step=1)
    monkeypatch.setattr(
        os, "listdir",
        lambda p: (_ for _ in ()).throw(OSError("transient")))
    monkeypatch.setattr(time, "sleep", lambda s: None)
    assert ClusterMonitor(d, n_hosts=1).scan() == {}
