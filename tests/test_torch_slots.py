"""The pieces continuous serving adds to the port, each against the JAX
reference where it has one, at reduce_for_smoke(qwen2-0.5b) in f32:

  * decode at per-row positions against the reference's `jax.vmap` of the
    B=1 decode (tolerance 1e-4 abs and rel: the same math in another
    summation order), and bitwise against the host-int path when every
    position is the same;
  * per-slot fingerprints and admission lanes from the reference's numpy
    logits and cache rows: h1 and h2 bitwise equal to
    `jax.vmap(tensor_fingerprint)` and to the reference's `_packed_fn`
    lanes (K1's plain version here, the kernel on the card);
  * the scheduler copy: the same `synthetic_requests`, admit order and
    percentiles as `repro.runtime.scheduler`;
  * the SlotRing's clone contract and the slot merge of a partial commit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.fingerprint import tensor_fingerprint as jtensor_fp
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.obs import percentile as jpercentile
from repro.runtime import scheduler as jsched
from repro.runtime.prefill import BucketedPrefill as JPrefill

from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.tiers import SlotRing
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.engine import slot_select
from repro_torch.core.fingerprint import lane_fingerprints, slot_fingerprints
from repro_torch.device import upload
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import scheduler as tsched

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduce(jget_config("qwen2-0.5b"))
    tcfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jmodel, jparams, tparams


def _hashes(fp) -> np.ndarray:
    """The h1/h2 words of (..., 4) fingerprints as u32."""
    a = fp.numpy() if isinstance(fp, torch.Tensor) else np.asarray(fp)
    return a.astype(np.int64).astype(np.uint32)[..., :2] if a.dtype != \
        np.uint32 else a[..., :2]


def _slot_caches(jcfg, n, T, seed):
    """Random per-slot caches in the reference's vmap layout (N, L, 1, T,
    KV, hd) and in the port's packed layout (L, N, T, KV, hd)."""
    r = np.random.RandomState(seed)
    shape = (n, jcfg.num_layers, 1, T, jcfg.num_kv_heads, jcfg.head_dim)
    ref = {k: r.standard_normal(shape).astype(np.float32) for k in "kv"}
    port = {k: torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(v[:, :, 0], 0, 1))) for k, v in ref.items()}
    return ref, port


def test_per_row_decode_matches_reference_vmap(model):
    jcfg, tcfg, _, jp, tp = model
    n, T = 3, 20
    ref, port = _slot_caches(jcfg, n, T, seed=5)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab_size, (n,))
    pos = np.array([4, 11, 0])
    jl, jc = jax.vmap(lambda c, tk, p: jtfm.lm_decode_step(jcfg, jp, c, tk,
                                                           p))(
        {k: jnp.asarray(v) for k, v in ref.items()},
        jnp.asarray(toks[:, None], jnp.int32), jnp.asarray(pos, jnp.int32))
    tl, tc = ttfm.lm_decode_step(tcfg, tp, port, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, 0], **TOL)
    for k in "kv":
        want = np.swapaxes(np.asarray(jc[k])[:, :, 0], 0, 1)
        np.testing.assert_allclose(tc[k].numpy(), want, **TOL)


def test_per_row_decode_is_bitwise_the_host_int_path(model):
    """Every row at one position: the tensor form gives the host-int
    form's logits and cache bit for bit."""
    jcfg, tcfg, *_, tp = model
    _, port = _slot_caches(jcfg, 3, 20, seed=7)
    other = {k: v.clone() for k, v in port.items()}
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, jcfg.vocab_size, (3,)))
    a, ca = ttfm.lm_decode_step(tcfg, tp, port, toks, 9)
    b, cb = ttfm.lm_decode_step(tcfg, tp, other, toks,
                                torch.full((3,), 9, dtype=torch.int64))
    assert torch.equal(a, b)
    for k in "kv":
        assert torch.equal(ca[k], cb[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_fingerprints_match_reference_vmap(dtype):
    x = (np.random.RandomState(9).standard_normal((4, 257)) * 3).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # the same bf16 rounding on both sides, so the same words
    np.testing.assert_array_equal(
        np.asarray(jx).view(np.uint16 if dtype == "bfloat16" else np.uint32),
        tx.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
        .view(np.uint16 if dtype == "bfloat16" else np.uint32))
    want = np.asarray(jax.vmap(jtensor_fp)(jx))
    active = torch.tensor([True, True, False, True])
    got = slot_fingerprints(tx, active)
    np.testing.assert_array_equal(_hashes(got)[[0, 1, 3]],
                                  _hashes(want)[[0, 1, 3]])
    assert not got[2].any()                  # an inactive slot's row is 0


def test_lanes_match_reference_packed_fn(model):
    """Lanes from the reference's own pack outputs: its logits (the same
    prefill the packed program runs) and its insert-layout cache rows,
    viewed in the port's layout as strided row views."""
    jcfg, tcfg, jmodel, jp, _ = model
    max_len, bucket = 20, 8
    lens = np.array([8, 5, 3, 1])
    toks = np.random.RandomState(10).randint(0, 200, (4, bucket))
    toks[np.arange(bucket)[None] >= lens[:, None]] = 0
    jt, jlens = jnp.asarray(toks, jnp.int32), jnp.asarray(lens, jnp.int32)
    out = JPrefill(jmodel, backend="sequential")._packed_fn(max_len)(
        jp, jt, jlens, jnp.asarray(0), jnp.asarray(0), jnp.asarray(0))
    logits, _ = jmodel.prefill(jp, {"tokens": jt, "lengths": jlens}, max_len)
    # the port's pack: model-layout cache (L, K, T, KV, hd), rows as views
    cache = {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(
        np.asarray(v.astype(jnp.float32))[:, :, 0], 0, 1))).to(
            torch.bfloat16) for k, v in out["rows"].items()}
    rows = {k: c.transpose(0, 1).unsqueeze(2) for k, c in cache.items()}
    assert not rows["k"][1].is_contiguous()
    got = lane_fingerprints(torch.from_numpy(np.array(logits)), rows)
    np.testing.assert_array_equal(_hashes(got), _hashes(out["lanes"]))


@pytest.mark.parametrize("kw", [
    dict(n=5, arrival_rate=2.0, prompt_lengths=(4, 8),
         max_new_choices=(4, 8), seed=1),
    dict(n=8, arrival_rate=0.5, prompt_lengths=(96, 200, 256),
         max_new_choices=(16, 32), vocab=151936, seed=0),
    dict(n=6, arrival_rate=1.0, prompt_lengths=(4, 8, 16),
         length_weights=(0.5, 0.3, 0.2), max_new_choices=(4, 12), seed=3)])
def test_scheduler_copy_matches_reference(kw):
    kw = dict(kw)
    n = kw.pop("n")
    mine = tsched.synthetic_requests(n, **kw)
    ref = jsched.synthetic_requests(n, **kw)
    assert [(r.rid, r.arrival, r.max_new_tokens, r.prompt.tolist())
            for r in mine] == \
        [(r.rid, r.arrival, r.max_new_tokens, r.prompt.tolist())
         for r in ref]

    def drive(mod, reqs):
        sched = mod.SlotScheduler(3, mod.RequestQueue(4))
        log = [[r.rid for r in reqs if not sched.queue.offer(r)]]
        for t in range(4):
            log.append([(s, r.rid) for s, r in sched.admit(t)])
            running = sched.running_items()
            if running:
                slot = running[t % len(running)][0]
                sched.drain(slot, finish_step=t + 1)
                if t % 2:
                    sched.reactivate(slot)
                else:
                    sched.release(slot)
            log.append([r.status for r in reqs])
        return log

    assert drive(tsched, mine) == drive(jsched, ref)


def test_latency_helpers_match_reference():
    vals = list(np.random.RandomState(11).exponential(1.0, 37))
    for q in (0, 1, 50, 90, 99, 100):
        assert tsched.percentile(vals, q) == jpercentile(vals, q) == \
            float(np.percentile(vals, q, method="inverted_cdf"))
    assert tsched.percentile([], 50) == 0.0
    reqs = tsched.synthetic_requests(4, seed=2)
    jreqs = jsched.synthetic_requests(4, seed=2)
    for i, (r, j) in enumerate(zip(reqs, jreqs)):
        r.arrival_time = j.arrival_time = float(i)
        r.token_times = j.token_times = [i + 0.5 + 0.1 * k
                                         for k in range(i + 1)]
    assert tsched.stream_stats_ms(reqs) == jsched.stream_stats_ms(jreqs)


def test_slot_ring_stores_and_hands_out_clones():
    ring = SlotRing(slots_per_key=2)
    cache = torch.zeros(2, 1, 4)
    sl = {"cache": {"k": cache}, "pos": torch.tensor(3)}
    ring.save(0, 5, sl)
    cache.add_(1.0)                          # the live cache moves on
    version, got = ring.restore(0, max_step=6)
    assert version == 5 and not got["cache"]["k"].any()
    got["cache"]["k"].add_(7.0)              # a restored copy is the caller's
    assert not ring.restore(0)[1]["cache"]["k"].any()
    ring.save_many(7, {0: sl, 1: sl})
    ring.save(0, 9, sl)                      # rotates version 5 out
    assert ring.versions(0) == [7, 9] and ring.versions(1) == [7]
    with pytest.raises(KeyError):
        ring.restore(0, max_step=6)
    assert ring.nbytes() == 3 * (8 * 4 + 8)
    ring.evict(0)
    with pytest.raises(KeyError):
        ring.restore(0)


def test_slot_select_merges_rows_and_keeps_the_shared_cache():
    cache = {"k": torch.ones(2, 3, 4)}
    old = {"cache": cache, "tok": torch.tensor([[1], [2], [3]]),
           "pos": torch.tensor([5, 6, 7]), "t": 4}
    new = {"cache": cache, "tok": torch.tensor([[8], [9], [10]]),
           "pos": torch.tensor([6, 7, 8]), "t": 5}
    got = slot_select(torch.tensor([True, False, True]), new, old, 3)
    assert got["cache"]["k"] is cache["k"]  # shares the in-place cache
    assert got["tok"].tolist() == [[8], [2], [10]]
    assert got["pos"].tolist() == [6, 6, 8] and got["t"] == 5


def test_upload_copies_on_the_cpu():
    x = np.arange(6).reshape(2, 3)
    t = upload(x, torch.device("cpu"))
    x[0, 0] = 99
    assert t.tolist() == [[0, 1, 2], [3, 4, 5]]
