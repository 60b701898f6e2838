"""The port's checkpoint tier hierarchy (`checkpoint/tiers.py`, tiered L2/L3
in `core/recovery.py`) against the JAX package's, on the toy step of the
reference's `tests/test_tiers.py` in both packages.

Held equal to JAX: the recovery records (kind, step, rollbacks, tier,
version and the fallbacks' tiers), the versions each tier holds, the
planner's candidate lists, the saves by tier, and the counts of disk reads
and host reads on the restore path. Bits come from inside the port: a
recovered run's state equals the port's own flat-disk run of the same
backend bitwise (the reference's fused replay is not bit-identical to its
lag-1 or disk-tier runs, so no bits are taken from it)."""
import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JStore
from repro.checkpoint import TieredCheckpointer as JTiered
from repro.checkpoint import TierSchedule as JSchedule
from repro.checkpoint import count_disk_reads as jcount_disk_reads
from repro.checkpoint import parse_tiers as jparse_tiers
from repro.configs import SedarConfig as JSedarConfig
from repro.core import fingerprint as jfp
from repro.core import hostsync as jhostsync
from repro.core.detection import DetectionEvent as JEvent
from repro.core.detection import SedarSafeStop as JSafeStop
from repro.core.injection import InjectionSpec as JSpec
from repro.core.injection import MemoryInjectionFlag as JFlag
from repro.core.injection import inject_tree as jinject
from repro.core.policy import make_engine as jmake_engine

from repro_torch.checkpoint import (CheckpointStore, DeviceRing, HostRing,
                                    TieredCheckpointer, TierSchedule,
                                    count_disk_reads, make_tiered,
                                    parse_tiers)
from repro_torch.configs import SedarConfig
from repro_torch.core import fingerprint as tfp
from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent, SedarSafeStop
from repro_torch.core.injection import InjectionSpec, MemoryInjectionFlag
from repro_torch.core.injection import inject_tree as tinject
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import (MultiCheckpointRecovery,
                                       ValidatedCheckpointRecovery,
                                       make_recovery)
from repro_torch.launch import train as launch_train
from repro_torch.tree import leaves

torch.set_num_threads(1)
N = 16
SPEC = dict(leaf_idx=0, flat_idx=5, bit=20, step=4, replica=1,
            target="grads")


# -- the toy workload in both packages ------------------------------------

def _jstep(spec):
    def step_fn(state, batch, rid, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        if spec is not None:
            delta = jinject({"d": delta}, spec, step=state["step"],
                            replica_id=rid, armed=armed)["d"]
        fp = jfp.pytree_fingerprint_fused({"d": delta})
        cand = {"x": state["x"] + delta, "step": state["step"] + 1}
        return cand, fp, jnp.sum(cand["x"])
    return jax.jit(step_fn)


def _tstep(spec):
    def step_fn(state, batch, rid, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        if spec is not None:
            delta = tinject({"d": delta}, spec, step=int(state["step"]),
                            replica_id=rid, armed=armed)["d"]
        fp = tfp.pytree_fingerprint_fused({"d": delta})
        cand = {"x": state["x"] + delta, "step": state["step"] + 1}
        return cand, fp, torch.sum(cand["x"])
    return step_fn


def _tfused(spec):
    """The fused contract: both replicas stacked on a leading axis, each
    replica's fault decided on its own row."""
    def step_fn(stacked, batch, armed):
        step = int(stacked["step"][0])
        rows, fps = [], []
        for r in range(2):
            d = 0.1 * batch - 0.01 * stacked["x"][r]
            if spec is not None:
                d = tinject({"d": d}, spec, step=step, replica_id=r,
                            armed=armed)["d"]
            rows.append(d)
            fps.append(tfp.pytree_fingerprint_fused({"d": d}))
        cand = {"x": stacked["x"] + torch.stack(rows),
                "step": stacked["step"] + 1}
        return cand, torch.stack(fps), torch.sum(cand["x"][0])
    return step_fn


def _cfg(pkg, level, backend, lag, ckpt_interval, tiers, slots,
         max_checkpoints, workdir):
    cls = JSedarConfig if pkg == "jax" else SedarConfig
    return cls(level=level, replication=backend, validate_interval=1,
               validate_lag=lag, param_validate_interval=0,
               checkpoint_interval=ckpt_interval,
               max_checkpoints=max_checkpoints, ckpt_tiers=tiers,
               device_ring_slots=slots, host_ring_slots=slots,
               checkpoint_dir=os.path.join(workdir, "ckpt"))


def _engine(pkg, workdir, level, spec=None, backend="sequential", lag=1,
            ckpt_interval=3, tiers="device,host,disk", slots=8,
            max_checkpoints=0):
    sedar = _cfg(pkg, level, backend, lag, ckpt_interval, tiers, slots,
                 max_checkpoints, workdir)
    if pkg == "jax":
        eng = jmake_engine(
            sedar, backend=backend, workdir=workdir,
            step_fn=_jstep(spec and JSpec(**spec)),
            state_fp_fn=jax.jit(lambda s: jfp.pytree_fingerprint(
                {"x": s["x"]})),
            fast_state_fp_fn=jax.jit(lambda s: jfp.pytree_fingerprint_fused(
                {"x": s["x"]})),
            inj_spec=spec and JSpec(**spec), inj_flag=JFlag(),
            init_fn=lambda: eng.executor.init_dual(
                {"x": jnp.zeros((N,), jnp.float32),
                 "step": jnp.zeros((), jnp.int32)}),
            notify=lambda e: None)
        return eng
    tspec = spec and InjectionSpec(**spec)
    eng = make_engine(
        sedar, backend=backend, workdir=workdir,
        step_fn=_tfused(tspec) if backend == "fused" else _tstep(tspec),
        state_fp_fn=lambda s: tfp.pytree_fingerprint({"x": s["x"]}),
        fast_state_fp_fn=lambda s: tfp.pytree_fingerprint_fused(
            {"x": s["x"]}),
        inj_spec=tspec, inj_flag=MemoryInjectionFlag(),
        init_fn=lambda: eng.executor.init_dual(
            {"x": torch.zeros((N,), dtype=torch.float32),
             "step": torch.zeros((), dtype=torch.int32)}),
        notify=lambda e: None, stack="leading")
    return eng


def _drive(pkg, eng, num_steps, on_event=None, max_iters=200):
    """The zero-sync loop that runs the engine in the reference's tests."""
    safe_stop = JSafeStop if pkg == "jax" else SedarSafeStop

    def batch(step):
        if pkg == "jax":
            return jnp.full((N,), float(step + 1), jnp.float32)
        return torch.full((N,), float(step + 1), dtype=torch.float32)

    def peek(dual):
        return int(np.asarray(eng.executor.peek(dual, "step")))

    dual = eng.init_dual()
    eng.reset()
    step = peek(dual)
    stopped, it = False, 0
    while True:
        if step >= num_steps:
            event = eng.flush_deferred()
            if event is None:
                break
            try:
                dual = eng.on_detection(event, dual)
            except safe_stop:
                stopped = True
                break
            step = peek(dual)
            continue
        it += 1
        assert it < max_iters, "engine did not converge"
        outcome = eng.run_protected_step(dual, batch(step), step)
        dual = outcome.dual
        if outcome.committed and outcome.aux is not None:
            step += 1
        if outcome.event is not None:
            try:
                dual = (on_event or (lambda e, ev, d: e.on_detection(ev, d)))(
                    eng, outcome.event, dual)
            except safe_stop:
                stopped = True
                break
            step = peek(dual)
    tiers = getattr(eng.recovery, "tiers", None)
    if tiers is not None:
        tiers.wait()
    return dual, stopped


def _counting(pkg):
    """on_event hook: on_detection inside disk-read and host-read counts."""
    counted = {}
    disk = jcount_disk_reads if pkg == "jax" else count_disk_reads
    host = jhostsync if pkg == "jax" else hostsync

    def on_event(eng, event, dual):
        with disk() as dr, host.count_transfers() as ht:
            dual = eng.on_detection(event, dual)
        counted.setdefault("disk_reads", []).append(dr.reads)
        counted.setdefault("transfers", []).append(ht.transfers)
        return dual
    return on_event, counted


def _x(eng, dual) -> np.ndarray:
    return np.asarray(eng.executor.peek(dual, "x"))


def _records(eng):
    """Recovery records with each fallback reduced to (tier, version): the
    error text names the package's own paths."""
    out = []
    for r in eng.recoveries:
        r = dict(r)
        if "fallbacks" in r:
            r["fallbacks"] = [(f["tier"], f["version"]) for f in r["fallbacks"]]
        out.append(r)
    return out


def _tiers_state(eng):
    t = eng.recovery.tiers
    return {"device": t.device.versions() if t.device else None,
            "host": t.host.versions() if t.host else None,
            "disk": t.disk.steps() if t.disk else None,
            "partner": t.partner.steps() if t.partner else None,
            "saves": dict(t.saves_by_tier)}


def _both(tmp_path, name, steps, *, on_event=False, **kw):
    """The scenario on both engines -> (port engine, port dual, JAX engine,
    JAX dual, port counts, JAX counts), after holding the event streams,
    the recovery records and the tiers' contents equal."""
    out = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, str(tmp_path / f"{pkg}_{name}"), **kw)
        hook, counted = _counting(pkg) if on_event else (None, {})
        dual, stopped = _drive(pkg, eng, steps, on_event=hook)
        out[pkg] = (eng, dual, stopped, counted)
    (te, td, ts, tc), (je, jd, js, jc) = out["torch"], out["jax"]
    assert [(e.step, e.boundary, e.effect) for e in te.detections] == \
        [(e.step, e.boundary, e.effect) for e in je.detections]
    assert _records(te) == _records(je)
    assert te.checkpoints == je.checkpoints
    assert ts == js
    if getattr(te.recovery, "tiers", None) is not None:
        assert _tiers_state(te) == _tiers_state(je)
    return te, td, je, jd, tc, jc


def _flat(tmp_path, name, steps, backend="sequential", level=2, lag=1,
          ckpt_interval=3):
    """The port's own fault-free flat-disk run: the bitwise oracle."""
    eng = _engine("torch", str(tmp_path / f"flat_{name}"), level,
                  backend=backend, lag=lag, ckpt_interval=ckpt_interval,
                  tiers="disk")
    dual, _ = _drive("torch", eng, steps)
    return _x(eng, dual)


def _toy(pkg, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(N).astype(np.float32)
    if pkg == "jax":
        return {"x": jnp.asarray(x), "step": jnp.asarray(seed, jnp.int32)}
    return {"x": torch.from_numpy(x),
            "step": torch.tensor(seed, dtype=torch.int32)}


# -- rings --------------------------------------------------------------------

def test_device_ring_roundtrip_no_host_reads_no_disk():
    ring = DeviceRing(slots=3)
    states = {s: _toy("torch", s) for s in (1, 2, 3)}
    with hostsync.count_transfers() as ht, count_disk_reads() as dr:
        for s, st in states.items():
            ring.save(s, st)
        r = ring.restore(2)
    assert ht.transfers == 0 and dr.reads == 0
    assert torch.equal(r["x"], states[2]["x"])


def test_device_ring_stores_and_returns_clones():
    """A saved state written in place afterwards, or a restored one, never
    changes the slot."""
    ring = DeviceRing(slots=2)
    st = _toy("torch", 7)
    want = st["x"].clone()
    ring.save(1, st)
    st["x"].add_(1.0)
    r1 = ring.restore(1)
    r1["x"].zero_()
    assert torch.equal(ring.restore(1)["x"], want)


@pytest.mark.parametrize("floor", [None, 5, 9])
def test_ring_eviction_keeps_floor_anchor_like_jax(floor):
    from repro.checkpoint import DeviceRing as JDeviceRing
    rings = {"jax": JDeviceRing(slots=2), "torch": DeviceRing(slots=2)}
    for s in (3, 6, 9, 12):
        for pkg, ring in rings.items():
            ring.save(s, _toy(pkg, s), keep_floor=floor)
    assert rings["torch"].versions() == rings["jax"].versions()
    if floor == 5:
        assert 3 in rings["torch"].versions()


def test_host_ring_restores_to_the_template_without_disk():
    ring = HostRing(slots=2)
    st = _toy("torch", 5)
    with count_disk_reads() as dr, hostsync.count_transfers() as ht:
        host = hostsync.batched_get(leaves(st), label="tier_host_save")
        ring.save(3, host, st)
        r = ring.restore(3, st)
    assert dr.reads == 0 and ht.batches == 1
    assert torch.equal(r["x"], st["x"]) and r["step"].dtype == torch.int32
    host[1][0] = 99.0          # the restore is a copy, not a view
    assert float(r["x"][0]) != 99.0
    with pytest.raises(ValueError, match="leaves"):
        ring.restore(3, {"x": st["x"]})
    # without a template: the saved structure, on the CPU; the ring holds
    # no reference to the saved state's tensors
    r2 = ring.restore(3)
    assert sorted(r2) == ["step", "x"] and r2["x"].device.type == "cpu"
    held = [x for _, (_, sk) in ring._ring for x in leaves(sk)]
    assert not any(isinstance(x, torch.Tensor) for x in held)


# -- schedule / facade --------------------------------------------------------

@pytest.mark.parametrize("spec", ["device, host ,disk", "disk", "",
                                  "partner,device", "device,ssd"])
def test_parse_tiers_like_jax(spec):
    try:
        want = jparse_tiers(spec)
    except ValueError:
        with pytest.raises(ValueError, match="unknown checkpoint tier"):
            parse_tiers(spec)
        return
    assert parse_tiers(spec) == want


@pytest.mark.parametrize("tiers", [
    "disk", "device", "host", "device,disk", "device,host,disk",
    "host,disk,partner", "device,host,disk,partner"])
@pytest.mark.parametrize("level", [2, 3])
def test_make_recovery_builds_every_tier_set_like_jax(tmp_path, tiers,
                                                      level):
    from repro.core.recovery import make_recovery as jmake_recovery
    kw = dict(level=level, checkpoint_interval=3, ckpt_tiers=tiers,
              device_ckpt_interval=1, host_ckpt_interval=0,
              partner_ckpt_interval=6, device_ring_slots=3,
              host_ring_slots=2)
    r = make_recovery(SedarConfig(**kw), str(tmp_path / "t"))
    jr = jmake_recovery(JSedarConfig(**kw), str(tmp_path / "j"))
    assert isinstance(r, MultiCheckpointRecovery if level == 2
                      else ValidatedCheckpointRecovery)
    if tiers == "disk":
        assert r.tiers is None and jr.tiers is None
        return
    assert r.tiers.schedule.enabled() == jr.tiers.schedule.enabled()
    assert [r.tiers.schedule.interval(t) for t in
            ("device", "host", "disk", "partner")] == \
        [jr.tiers.schedule.interval(t) for t in
         ("device", "host", "disk", "partner")]
    for name in ("device", "host"):
        ring, jring = getattr(r.tiers, name), getattr(jr.tiers, name)
        assert (ring is None) == (jring is None)
        if ring is not None:
            assert ring.slots == jring.slots
    if "partner" in tiers:
        assert r.tiers.partner.dir.endswith("checkpoints_partner")
    assert [r.due(s) if level == 2 else None for s in range(13)] == \
        [jr.due(s) if level == 2 else None for s in range(13)]
    if level == 2:
        assert [(r.fp_needed(s), r.sync_due(s)) for s in range(13)] == \
            [(jr.fp_needed(s), jr.sync_due(s)) for s in range(13)]


def test_make_tiered_flat_disk_is_none(tmp_path):
    sedar = SedarConfig(level=2, ckpt_tiers="disk")
    assert make_tiered(sedar, str(tmp_path),
                       disk_store=CheckpointStore(str(tmp_path))) is None


def test_save_routes_by_cadence_one_shared_transfer(tmp_path):
    """host + disk due on one step share ONE batched copy to the host."""
    tc = TieredCheckpointer(TierSchedule(device=1, host=4, disk=4),
                            disk_store=CheckpointStore(str(tmp_path)))
    st = _toy("torch", 1)
    with hostsync.count_transfers() as ht:
        assert tc.save(1, st, async_=False) == ["device"]
    assert ht.transfers == 0
    with hostsync.count_transfers() as ht:
        assert tc.save(4, st, async_=False) == ["device", "host", "disk"]
    assert ht.batches == 1 and list(ht.by_label) == ["checkpoint_save"]
    assert tc.saves_by_tier == {"device": 2, "host": 1, "disk": 1}


def _planners():
    """The same version history in both packages' planners."""
    out = {}
    for pkg in ("jax", "torch"):
        cls = JTiered if pkg == "jax" else TieredCheckpointer
        sched = (JSchedule if pkg == "jax" else TierSchedule)(device=1,
                                                              host=1)
        tc = cls(sched, device_slots=4, host_slots=4)
        st = _toy(pkg, 0)
        if pkg == "jax":
            lv, treedef = jax.tree_util.tree_flatten(st)
            host = ([np.asarray(l) for l in lv], treedef)
        else:
            host = ([a.numpy() for a in leaves(st)], st)
        for v in (1, 2, 3):
            tc.device.save(v, st)
            tc.host.save(v, *host)
        out[pkg] = tc
    return out


@pytest.mark.parametrize("query", [dict(version=3), dict(version=2),
                                   dict(max_step=3), dict(max_step=2),
                                   dict(version=3, max_step=2)])
def test_planner_candidates_like_jax(query):
    p = _planners()
    assert p["torch"].plan(**query) == p["jax"].plan(**query)
    for pkg in p:
        p[pkg].device.keep_only(3)
    assert p["torch"].plan(**query) == p["jax"].plan(**query)
    if query == dict(version=2):
        assert p["torch"].plan(**query)[0] == ("host", 2)


def test_planner_rework_outweighs_tier_cost_at_distance(tmp_path):
    tc = TieredCheckpointer(TierSchedule(device=1, disk=1), device_slots=2,
                            disk_store=CheckpointStore(str(tmp_path)))
    st = _toy("torch", 0)
    tc.device.save(2, st)
    tc.disk.save(100, st, async_=False)
    # cost(device@2) = 1 + 98; cost(disk@100) = 64 + 0 -> disk wins
    assert tc.plan(max_step=100)[0] == ("disk", 100)


def test_restore_without_candidates_raises():
    tc = TieredCheckpointer(TierSchedule(device=1))
    with pytest.raises(KeyError, match="no restorable version"):
        tc.restore(3, _toy("torch", 0))


# -- engine-level: L2 over the hierarchy ---------------------------------------

@pytest.mark.parametrize("backend", ["sequential", "fused"])
def test_l2_fault_recovers_from_device_ring_zero_disk_reads(tmp_path,
                                                            backend):
    """A fault at step 4 under L2 with a device slot <= 4: the restore comes
    from Tier 0 with 0 disk reads and 0 host reads, as in the reference;
    the replay equals the port's flat-disk run of the same backend."""
    te, td, _, _, tc, jc = _both(tmp_path, f"ring_{backend}", 10,
                                 on_event=True, level=2, spec=SPEC,
                                 backend=backend)
    assert tc == jc == {"disk_reads": [0], "transfers": [0]}
    rec = te.recoveries[0]
    assert rec["tier"] == "device" and rec["step"] <= SPEC["step"]
    assert np.array_equal(_x(te, td), _flat(tmp_path, backend, 10, backend))


def test_l2_deferred_window_fault_restores_from_ring(tmp_path):
    """Fused at lag 4: the ring holds optimistic slots; the bound at the
    faulty step keeps them out and the restore still comes from Tier 0."""
    te, td, _, _, tc, _ = _both(tmp_path, "deferred", 12, on_event=True,
                                level=2, spec=SPEC, backend="fused", lag=4)
    assert tc["disk_reads"] == [0]
    ev = te.detections[0]
    assert ev.boundary == "deferred" and ev.step == SPEC["step"]
    assert te.recoveries[0]["tier"] == "device"
    assert np.array_equal(_x(te, td),
                          _flat(tmp_path, "fused_l1", 12, "fused"))


def test_l2_ring_too_short(tmp_path):
    te, td, _, _, _, _ = _both(tmp_path, "short", 10, level=2, spec=SPEC,
                               slots=1, tiers="device,disk")
    assert te.recoveries[0]["tier"] in ("device", "disk")
    assert te.recoveries[0]["step"] <= SPEC["step"]
    assert np.array_equal(_x(te, td), _flat(tmp_path, "short", 10))


def test_l2_sparse_ring_falls_to_disk(tmp_path):
    """A 1-slot ring every 5 steps and the disk every 2: the fault at step 7
    walks to version 6, which only the disk holds."""
    late = dict(SPEC, step=7)
    out = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, str(tmp_path / pkg), 2, spec=late,
                      tiers="device,disk", slots=1, ckpt_interval=2)
        eng.recovery.tiers.schedule = (
            JSchedule if pkg == "jax" else TierSchedule)(device=5, disk=2)
        hook, counted = _counting(pkg)
        dual, _ = _drive(pkg, eng, 10, on_event=hook)
        out[pkg] = (eng, dual, counted)
    (te, td, tc), (je, _, jc) = out["torch"], out["jax"]
    assert _records(te) == _records(je)
    assert [(r["tier"], r["version"]) for r in te.recoveries] == [("disk", 6)]
    assert tc["disk_reads"] == jc["disk_reads"] and tc["disk_reads"][0] > 0
    assert np.array_equal(_x(te, td), _flat(tmp_path, "sparse", 10,
                                            ckpt_interval=2))


def test_l2_multi_rollback_walks_union_newest_first(tmp_path):
    """Alg. 1 over the hierarchy: repeated detections walk the UNION of the
    tiers' versions at or below the faulty step, one back each time."""
    recs = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, str(tmp_path / pkg), 2, slots=4)
        dual, _ = _drive(pkg, eng, 8)
        assert _tiers_state(eng)["device"] == [5, 6, 7, 8]
        ev = (JEvent if pkg == "jax" else DetectionEvent)(
            step=7, boundary="validate", effect="FSC")
        for _ in range(4):
            dual = eng.on_detection(ev, dual)
        recs[pkg] = _records(eng)
    assert recs["torch"] == recs["jax"]
    assert [(r["step"], r["tier"]) for r in recs["torch"]] == \
        [(7, "device"), (6, "device"), (5, "device"), (3, "host")]


def _flip_leaf_byte(store_dir, step, leaf=0):
    path = os.path.join(store_dir, f"ckpt_{step:08d}", f"leaf_{leaf:05d}.npy")
    arr = np.load(path)
    arr.reshape(-1).view(np.uint8)[3] ^= 0x10
    np.save(path, arr)


def test_corrupt_disk_falls_back_to_partner_then_host(tmp_path):
    """A flipped byte in a Tier-2 leaf: the partner serves the version;
    corrupt the partner too: the host ring serves an older version. Each
    fallback is an event, as in the reference."""
    infos, n_events = {}, {}
    for pkg in ("jax", "torch"):
        events = []
        sched = (JSchedule if pkg == "jax" else TierSchedule)(
            device=0, host=2, disk=4, partner=4)
        store = JStore if pkg == "jax" else CheckpointStore
        tc = (JTiered if pkg == "jax" else TieredCheckpointer)(
            sched, host_slots=2,
            disk_store=store(str(tmp_path / pkg / "disk")),
            partner_store=store(str(tmp_path / pkg / "partner")),
            notify=events.append)
        states = {s: _toy(pkg, s) for s in (2, 4)}
        tc.save(2, states[2], async_=False)
        tc.save(4, states[4], async_=False)
        tc.host.keep_only(2)
        tpl = states[4] if pkg == "torch" else jax.tree.map(np.asarray,
                                                           states[4])
        _flip_leaf_byte(str(tmp_path / pkg / "disk"), 4)
        s1, i1 = tc.restore(4, tpl)
        _flip_leaf_byte(str(tmp_path / pkg / "partner"), 4)
        s2, i2 = tc.restore(4, tpl)
        infos[pkg] = [(i["tier"], i["version"],
                       [f["tier"] for f in i.get("fallbacks", [])])
                      for i in (i1, i2)]
        n_events[pkg] = len(events)
        if pkg == "torch":
            assert torch.equal(s1["x"], states[4]["x"])
            assert torch.equal(s2["x"], states[2]["x"])
            assert all(e["kind"] == "tier_fallback" for e in events)
    assert infos["torch"] == infos["jax"] == [
        ("partner", 4, ["disk"]), ("host", 2, ["disk", "partner"])]
    assert n_events["torch"] == n_events["jax"] == 3


def test_every_tier_failing_raises_corruption(tmp_path):
    from repro_torch.checkpoint import CheckpointCorruptionError
    tc = TieredCheckpointer(TierSchedule(disk=4),
                            disk_store=CheckpointStore(str(tmp_path)))
    st = _toy("torch", 4)
    tc.save(4, st, async_=False)
    _flip_leaf_byte(str(tmp_path), 4)
    with pytest.raises(CheckpointCorruptionError, match="every tier"):
        tc.restore(4, st)


def test_engine_records_fallback_on_corrupt_tier2(tmp_path):
    def corrupt_then_recover(eng, event, dual):
        eng.recovery.store.wait()
        _flip_leaf_byte(eng.recovery.store.dir, 3)
        return eng.on_detection(event, dual)

    out = {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, str(tmp_path / pkg), 2, spec=SPEC,
                      tiers="host,disk,partner", slots=1)
        dual, stopped = _drive(pkg, eng, 10, on_event=corrupt_then_recover)
        assert not stopped
        out[pkg] = (eng, dual)
    te, td = out["torch"]
    assert _records(te) == _records(out["jax"][0])
    assert te.recoveries[0]["tier"] in ("host", "partner")
    assert np.array_equal(_x(te, td), _flat(tmp_path, "corrupt", 10))


def test_l3_keeps_exactly_one_valid_per_tier(tmp_path):
    te, td, _, _, tc, jc = _both(tmp_path, "l3", 10, on_event=True, level=3,
                                 spec=SPEC,
                                 tiers="device,host,disk,partner")
    tiers = te.recovery.tiers
    assert _tiers_state(te)["device"] == [9] and tiers.host.versions() == [9]
    assert tiers.disk.steps() == [9] and tiers.partner.steps() == [9]
    assert tiers.disk.manifest(9).valid is True
    assert tiers.partner.manifest(9).valid is True
    assert te.recoveries[0]["tier"] == "device"
    # Alg. 2's target lookup reads the disk and partner manifests; the
    # state itself comes from the device ring
    assert tc == jc == {"disk_reads": [2], "transfers": [0]}
    assert np.array_equal(_x(te, td),
                          _flat(tmp_path, "l3", 10, level=3))


@pytest.mark.parametrize("backend", ["sequential", "fused"])
def test_device_tier_saves_do_not_break_zero_sync(tmp_path, backend):
    """Tiered L2 with a device save every step keeps the deferred window's
    property: a fault-free step reads nothing from the device and nothing
    from the disk."""
    eng = _engine("torch", str(tmp_path), 2, backend=backend, lag=8,
                  ckpt_interval=100, tiers="device,disk")
    dual = eng.init_dual()
    eng.reset()
    with hostsync.count_transfers() as ht, count_disk_reads() as dr:
        for s in range(7):
            out = eng.run_protected_step(
                dual, torch.full((N,), float(s + 1)), s)
            dual = out.dual
            assert out.event is None
    assert ht.transfers == 0, ht.by_label
    assert dr.reads == 0
    assert eng.recovery.tiers.device.versions() == [1, 2, 3, 4, 5, 6, 7]


def test_bounded_chain_gc_only_runs_on_durable_saves(tmp_path, monkeypatch):
    eng = _engine("torch", str(tmp_path), 2, tiers="device,disk",
                  max_checkpoints=2)
    tiers = eng.recovery.tiers
    calls = []
    orig = tiers.disk.gc_keep_last
    monkeypatch.setattr(tiers.disk, "gc_keep_last",
                        lambda *a, **k: (calls.append(1), orig(*a, **k)))
    _, stopped = _drive("torch", eng, 8)
    assert not stopped
    assert len(calls) == 2 and tiers.disk.steps() == [3, 6]


def test_drop_volatile_leaves_only_the_durable_tiers(tmp_path):
    eng = _engine("torch", str(tmp_path), 2)
    dual, _ = _drive("torch", eng, 8)
    tiers = eng.recovery.tiers
    tiers.drop_volatile()
    assert tiers.device.versions() == [] and tiers.host.versions() == []
    assert tiers.plan(max_step=8) == [("disk", 6), ("disk", 3)]
    tiers.clear()
    assert tiers.versions() == []


def test_launcher_takes_ckpt_tiers(tmp_path, monkeypatch):
    argv = ["train", "--device", "cpu", "--steps", "6", "--level", "3",
            "--ckpt-interval", "2", "--inject-step", "3", "--ckpt-tiers",
            "device,host,disk", "--workdir", str(tmp_path / "wd")]
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main()
    text = out.getvalue()
    assert "restored_from=['device']" in text
    assert "'tier': 'device', 'version': 2" in text
    assert os.listdir(tmp_path / "wd" / "checkpoints") == ["ckpt_00000006"]
