"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version (K1 on packed buffers and on leaves read in place, one launch per
call), the protected serving path through K1/K2, the ABFT slice
(K3, K4, a replica-free generate), training (the replicas' grads, fused's
stacked grads, a device-tier restore), the replica campaign at n=4096 and
the telemetry loop at full width (no added read or launch; a journaled
fault run that reconciles), the chunked attentions and F3's non-finite
residual on CUDA tensors. Every test
here is marked `cuda` and skips without a card. The file imports nothing of
JAX, so it also runs on a machine without it:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.abft import kernels as kab
from repro_torch.abft.ref import attention_checksum_encode, attention_verify
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core import fingerprint as tfp
from repro_torch.core import hostsync
from repro_torch.core.injection import InjectionSpec, make_kernel_fault
from repro_torch.core.policy import make_server
from repro_torch.device import make_deterministic
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import flash_attention as kfa

pytestmark = pytest.mark.cuda

# (B, H, KV, Sq, Sk, hd, causal, window): ragged tiles, GQA, windows
ATTN_CASES = [
    (2, 4, 2, 20, 20, 16, True, 0),
    (1, 4, 1, 37, 37, 16, True, 0),
    (2, 2, 2, 33, 33, 16, True, 5),
    (1, 4, 2, 20, 33, 16, False, 0),
    (1, 2, 1, 150, 150, 64, True, 7),
    (2, 14, 2, 130, 130, 64, True, 0),
    (1, 4, 2, 257, 257, 64, True, 0),      # a last KV tile of 1 key
    (1, 4, 2, 100, 190, 64, False, 0),     # Sq != Sk, non-causal
    (2, 4, 2, 200, 200, 64, True, 100),    # window across a 64-key tile edge
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -q "
                    "--noconftest -m cuda tests/test_torch_cuda.py` on the card")
    make_deterministic(torch.device("cuda"))   # K3's plain version: no TF32
    return torch.device("cuda")


@pytest.mark.parametrize("n", [0, 1, 127, 128 * 256 + 1, 607_744, 3_000_001,
                               100_000_000])
def test_k1_kernel_bitwise_vs_plain(card, n):
    """h1, h2 and absmax are exact in any order, so equal to the plain
    version's words they are also equal to any earlier K1 body's (the
    two-pass kernel before the one-launch design was held to the same
    plain words at these sizes); the sum is a float reduction."""
    r = np.random.RandomState(n % 2 ** 31)
    x = torch.from_numpy((r.standard_normal(n) * 3).astype(np.float32)).to(card)
    u = x.view(torch.int32)
    before = kfp.launch_count.n
    got = kfp.fingerprint_u32(u)
    want = kfp.fingerprint_plain(u)
    torch.cuda.synchronize()
    assert kfp.launch_count.n == before + 1
    g, w = got.cpu().numpy().view(np.uint32), want.cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(g[:2], w[:2])
    assert g[3] == w[3]                                  # absmax: exact
    gs, ws = g[2:3].view(np.float32)[0], w[2:3].view(np.float32)[0]
    assert abs(float(gs) - float(ws)) <= 1e-5 * max(float(x.abs().sum()), 1.0)
    assert torch.equal(got, kfp.fingerprint_u32(u))      # every bit, s too
    if n > 8:   # a start off the 16-byte boundary: element loads
        np.testing.assert_array_equal(
            kfp.fingerprint_u32(u[1:]).cpu().numpy().view(np.uint32)[:2],
            kfp.fingerprint_plain(u[1:]).cpu().numpy().view(np.uint32)[:2])


def _launches(fn, iters: int = 10):
    """Kernel launch calls the host made per call of fn(), and the names of
    the kernels the device ran, by torch.profiler over `iters` calls. The
    host's launch calls are the count: the profiler's device records of
    this torch build can miss a kernel now and then (19 of 20 seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    calls = sum(e.count for e in evs if e.device_type == DeviceType.CPU
                and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return calls / iters, {e.key for e in evs
                           if e.device_type == DeviceType.CUDA}


def test_k1_is_one_launch_and_resets_its_ticket(card):
    """One launch per call (no second pass, no fill of the output), and
    back-to-back calls, which reuse the stream's ticket, all agree."""
    u = (torch.randn(607_744, device=card) * 3).view(torch.int32)
    kfp.fingerprint_u32(u)                                # workspace exists
    calls, names = _launches(lambda: kfp.fingerprint_u32(u))
    assert calls == 1 and len(names) == 1 and "fp_leaves" in names.pop()
    outs = [kfp.fingerprint_u32(u) for _ in range(5)]     # no sync between
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = kfp.fingerprint_plain(u)
    assert torch.equal(outs[0][[0, 1, 3]], want[[0, 1, 3]])


def test_k1_calls_on_two_streams(card):
    """Two streams, each with its own ticket and partials, calls in flight
    together: each result equals the plain version's words."""
    xs = [(torch.randn(3_000_001, device=card) * (i + 1)).view(torch.int32)
          for i in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in xs]
    outs = [[], []]
    for _ in range(4):
        for i, (st, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(st):
                outs[i].append(kfp.fingerprint_u32(x))
    torch.cuda.synchronize()
    for x, res in zip(xs, outs):
        want = kfp.fingerprint_plain(x)
        for o in res:
            assert torch.equal(o[[0, 1, 3]], want[[0, 1, 3]])


def _cache_tree(card, dtype, pos, max_len=300, L=3, B=2, KV=2, hd=64,
                seed=0):
    """The hybrid backend's fingerprint tree: KV-cache slices c[:, :, :pos]
    of (L, B, max_len, KV, hd) caches and an int64 token."""
    g = torch.Generator(device=card).manual_seed(seed)
    cache = {name: torch.randn(L, B, max_len, KV, hd, generator=g,
                               device=card).to(dtype) for name in "kv"}
    tok = torch.randint(-2 ** 40, 2 ** 40, (B,), generator=g, device=card)
    return {"cache": {n: c[:, :, :pos] for n, c in cache.items()}, "tok": tok}


def _odd_tree(card):
    """Leaves of every kind the kernel reads in place, with lengths that are
    not multiples of 4, an empty leaf and an unaligned view."""
    g = torch.Generator(device=card).manual_seed(1)
    f = torch.randn(1001, generator=g, device=card)
    return {"a": f[3:],                                     # 12 bytes off
            "b": torch.randn(7, 5, generator=g, device=card).bfloat16(),
            # words below 0x7F800000 are finite as f32, so absmax is a
            # number, compared bit for bit (of a NaN only the kind is)
            "c": torch.randint(0, 0x7F800000, (13,), generator=g,
                               device=card, dtype=torch.int32),
            "d": torch.randint(0, 2 ** 20, (3, 3), generator=g, device=card)
            * 2 ** 32 + torch.randint(0, 0x7F800000, (3, 3), generator=g,
                                      device=card),
            "e": torch.zeros(0, device=card),
            "f": torch.randn(9, 33, generator=g, device=card)[:, 1:30],
            "g": torch.randn(5, generator=g, device=card).bfloat16()[1:]}


@pytest.mark.parametrize("tree", ["cache_bf16_1", "cache_bf16_63",
                                  "cache_bf16_264", "cache_f32_63",
                                  "cache_bf16_300", "odd"])
def test_k1_leaves_bitwise_vs_pack_and_plain(card, tree):
    if tree == "odd":
        t = _odd_tree(card)
    else:
        _, dt, pos = tree.split("_")
        t = _cache_tree(card, {"bf16": torch.bfloat16,
                               "f32": torch.float32}[dt], int(pos))
    table = kfp.leaf_table(tree_util.leaves(t))
    assert table is not None
    before = kfp.launch_count.n
    got = tfp.pytree_fingerprint_fused(t)
    assert kfp.launch_count.n == before + 1
    want = kfp.fingerprint_plain(tfp.pack_tree_u32(t))
    assert torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])
    assert torch.equal(got[[0, 1, 3]], kfp.fingerprint_leaves_plain(table)
                       [[0, 1, 3]])
    assert torch.equal(got, tfp.pytree_fingerprint_fused(t))
    # in place: the one K1 launch and nothing else (no cast, copy or cat)
    calls, names = _launches(lambda: tfp.pytree_fingerprint_fused(t))
    assert calls == 1 and len(names) == 1 and "fp_leaves" in names.pop()


def test_k1_takes_a_126_leaf_training_state_in_one_launch(card):
    """recurrentgemma's {params, adamw m, v} (126 leaves, reduced widths):
    more leaves than a 64-row table holds, so K1 takes its 512-row table.
    One launch, read in place (no packed copy: the one launch call is
    K1's), hash words and absmax equal to the packed plain version's, and
    bitwise repeatable."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    cfg = reduce_for_smoke(get_config("recurrentgemma-2b"))
    params = build_model(cfg, card).init(seed=0)
    opt = make_optimizer(TrainConfig(optimizer="adamw")).init(params)
    gen = torch.Generator(device=card).manual_seed(5)
    opt = tree_util.tree_map(lambda t: torch.randn(
        t.shape, generator=gen, device=card), opt)     # not all zeros
    t = {"params": params, "opt": opt}
    table = kfp.leaf_table(tree_util.leaves(t))
    assert table is not None and len(table) == 126 > 64
    before = kfp.launch_count.n
    got = tfp.pytree_fingerprint_fused(t)
    assert kfp.launch_count.n == before + 1
    want = kfp.fingerprint_plain(tfp.pack_tree_u32(t))
    assert torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])
    assert torch.equal(got[[0, 1, 3]], kfp.fingerprint_leaves_plain(table)
                       [[0, 1, 3]])
    assert torch.equal(got, tfp.pytree_fingerprint_fused(t))
    calls, names = _launches(lambda: tfp.pytree_fingerprint_fused(t))
    assert calls == 1 and len(names) == 1 and "fp_leaves" in names.pop()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", ATTN_CASES)
def test_k2_kernel_vs_plain(card, dtype, B, H, KV, Sq, Sk, hd, causal,
                            window):
    r = np.random.RandomState(Sq)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                ).to(card, dtype)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    before = kfa.launch_count.n
    got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = kfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kfa.launch_count.n == before + 1
    # f32: summation order only; bf16: one rounding of the output, at most
    # one step of 2^-7 of the value
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=1e-3, rtol=8e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype == torch.bfloat16:   # fixed order, no atomics: the same bits
        again = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        assert torch.equal(got, again)


# bf16 only (the f32 body keeps hd 16 and 64): the model families' head
# dims, causal and windowed with Sk > window, ragged tiles, GQA, Sq != Sk
ATTN_WIDE_CASES = [
    (2, 16, 8, 130, 130, 128, True, 0),    # internvl2-2b's heads
    (1, 32, 8, 257, 257, 128, True, 0),    # phi3.5-moe's heads
    (1, 4, 2, 100, 190, 128, False, 0),
    (2, 4, 2, 300, 300, 128, True, 100),
    (1, 10, 1, 320, 320, 256, True, 128),  # recurrentgemma-2b's heads
    (2, 10, 1, 200, 200, 256, True, 0),
    (1, 4, 1, 70, 150, 256, False, 0),
    (1, 2, 1, 333, 333, 256, True, 77),
]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", ATTN_WIDE_CASES)
def test_k2_bf16_wide_head_dims_vs_plain(card, B, H, KV, Sq, Sk, hd, causal,
                                         window):
    """K2 bf16 at hd 128 and 256 (64-column panels): within one bf16
    rounding step of the plain version, bitwise repeatable, one launch."""
    r = np.random.RandomState(Sq + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                ).to(card, torch.bfloat16)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    before = kfa.launch_count.n
    got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = kfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kfa.launch_count.n == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=8e-3)
    again = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)


def test_k2_counts_each_launch_by_its_shape(card):
    """K2's wrapper counts a launch under (B, H, KV, Sq, Sk, hd, causal,
    window, dtype): chip_smoke holds K2 against its plain version at every
    shape a path launched it at."""
    q = torch.zeros((1, 10, 40, 256), device=card, dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 40, 256), device=card, dtype=torch.bfloat16)
    kfa.launch_count.reset()
    for _ in range(2):
        kfa.flash_attention_fwd(q, k, k, causal=True, window=32)
    kfa.flash_attention_fwd(q[:, :2], k, k, causal=False)
    assert kfa.launch_count.n == 3
    assert dict(kfa.launch_count.shapes) == {
        (1, 10, 1, 40, 40, 256, 1, 32, torch.bfloat16): 2,
        (1, 2, 1, 40, 40, 256, 0, 0, torch.bfloat16): 1}
    kfa.launch_count.reset()
    assert kfa.launch_count.n == 0 and not kfa.launch_count.shapes


# (B, H, KV, Sq, Sk, hd, causal, window): the f32 body's wide head dims
# (hd 128: two K/V stages, one block per SM; hd 256: one K and one V tile)
ATTN_F32_WIDE_CASES = [
    (1, 4, 2, 130, 130, 128, True, 0),
    (1, 4, 2, 100, 190, 128, False, 0),
    (2, 4, 2, 200, 200, 128, True, 70),
    (1, 4, 1, 257, 257, 256, True, 0),     # a last KV tile of 1 key
    (1, 2, 1, 333, 333, 256, True, 77),
    (1, 4, 2, 70, 150, 256, False, 0),
]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window",
                         ATTN_F32_WIDE_CASES)
def test_k2_f32_and_k4_wide_head_dims_vs_plain(card, B, H, KV, Sq, Sk, hd,
                                               causal, window):
    """K2 f32 and K4 (one f32 body) at hd 128 and 256 against their plain
    versions within atol/rtol 1e-5, one launch each, bitwise repeatable; a
    bit-23 flip of K4's largest output is flagged uncorrectable by the
    checksum verdict, the clean output is not."""
    r = np.random.RandomState(Sq + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                ).to(card)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    before = (kfa.launch_count.n, kab.flash_ck_launch_count.n)
    got = kfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    v_aug = attention_checksum_encode(v)
    full = kab.flash_attention_ck(q, k, v_aug, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (kfa.launch_count.n, kab.flash_ck_launch_count.n) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, kfa.flash_attention_plain(
        q, k, v, causal=causal, window=window), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(full, kfa.flash_attention_plain(
        q, k, v_aug, causal=causal, window=window), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, kfa.flash_attention_fwd(q, k, v, causal=causal,
                                                    window=window))
    assert torch.equal(full, kab.flash_attention_ck(q, k, v_aug,
                                                    causal=causal,
                                                    window=window))
    _, clean = attention_verify(full, Sk)
    flat = int(full[..., :hd].abs().argmax())
    spec = InjectionSpec(leaf_idx=0, flat_idx=flat // hd * (hd + 1)
                         + flat % hd, bit=23, step=0, target="kernel")
    _, rep = attention_verify(make_kernel_fault(spec, step=0, armed=True)(
        full), Sk)
    assert not bool(clean.detected)
    assert bool(rep.detected) and bool(rep.uncorrectable)


@pytest.mark.parametrize("L", [1, 2, 3, 8, 16])
def test_k1_lanes_vs_plain(card, L):
    """K1's lanes in one launch over leaves read in place (f32, bf16,
    int64, a strided view; leaves split at lane boundaries, a zero-padded
    tail): h1 and h2 of every lane bitwise equal to the plain lanes over
    the packed words; absmax a NaN in the same lanes as the plain one (an
    int64 word read as a float can be a NaN pattern, which both return, as
    the reference's max does) and bitwise equal in the others; L = 1
    equals the fused fingerprint."""
    g = torch.Generator(device=card).manual_seed(L)
    wide = torch.randn(300, 70, generator=g, device=card)
    tree = {"a": torch.randn(1000, 37, generator=g, device=card),
            "b": torch.randn(513, generator=g, device=card).to(
                torch.bfloat16),
            "c": torch.randint(-2 ** 40, 2 ** 40, (77,), generator=g,
                               device=card),
            "d": wide[:, 3:64]}
    before = kfp.launch_count.n
    got = tfp.pytree_fingerprint_lanes(tree, L)
    torch.cuda.synchronize()
    assert kfp.launch_count.n == before + 1 and got.shape == (L, 4)
    u = tfp.pack_tree_u32(tree)
    width = -(-u.numel() // L)
    u = torch.cat([u, u.new_zeros(L * width - u.numel())])
    want = torch.stack([kfp.fingerprint_plain(w) for w in u.view(L, width)])
    assert torch.equal(got[:, :2], want[:, :2])
    nan = torch.isnan(want[:, 3].view(torch.float32))
    assert torch.equal(torch.isnan(got[:, 3].view(torch.float32)), nan)
    assert torch.equal(got[~nan, 3], want[~nan, 3])
    assert torch.equal(got, tfp.pytree_fingerprint_lanes(tree, L))
    if L == 1:
        assert torch.equal(got[0], tfp.pytree_fingerprint_fused(tree))


def test_k2_bf16_unaligned_view_raises_without_launch(card):
    """The bf16 kernel's 16-byte copies need 16-byte aligned inputs: a view
    one element off the boundary is refused before any launch."""
    buf = torch.zeros(2 * 64 * 64 + 1, device=card, dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 64, 64)
    k = torch.zeros(1, 2, 64, 64, device=card, dtype=torch.bfloat16)
    before = kfa.launch_count.n
    with pytest.raises(ValueError, match="16-byte aligned"):
        kfa.flash_attention_fwd(q, k, k)
    assert kfa.launch_count.n == before


def test_protected_generate_through_both_kernels(card):
    """Small bf16 model on the card: both kernels launch on the path, the
    two replicas agree bit for bit (no detection on a clean run), no device
    read escapes `hostsync`, and an injected fault is detected, retried and
    leaves the tokens unchanged."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="bfloat16", attention_impl="pallas")
    steps = 6
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, 200, (2, 8))).to(card)
    srv = make_server(RunConfig(model=cfg), dual=True, device=card)
    params = srv.model.init(seed=0)
    kfp.launch_count.reset()
    kfa.launch_count.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with hostsync.count_transfers() as st:
            toks, rep = srv.generate(params, {"tokens": prompt}, steps=steps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not rep.detections and not rep.stopped
    assert kfp.launch_count.n == 2 * (steps - 1)
    assert kfa.launch_count.n == cfg.num_layers
    assert st.by_label == {"commit_compare": steps - 1, "token_emit": steps}

    plain, _ = make_server(RunConfig(model=cfg), device=card).generate(
        params, {"tokens": prompt}, steps=steps)
    np.testing.assert_array_equal(plain, toks)

    spec = InjectionSpec(leaf_idx=2, flat_idx=3, bit=30, step=10, replica=1,
                         target="params")
    fsrv = make_server(RunConfig(model=cfg), dual=True, device=card,
                       inj_spec=spec)
    ftoks, frep = fsrv.generate(params, {"tokens": prompt}, steps=steps)
    assert [(e.step, e.boundary, e.effect) for e in frep.detections] == \
        [(10, "commit", "TDC")]
    assert frep.retries == 1 and not frep.stopped
    np.testing.assert_array_equal(ftoks, toks)


# (M, K, N) of K3's operands: ragged tiles, smaller than one tile, and the
# encoded qwen2-0.5b MLP up- and down-projections of 4 x 256 prompt tokens
K3_CASES = [(25, 16, 21), (8, 5, 4), (1, 7, 1), (65, 33, 130), (129, 17, 63),
            (1025, 896, 4865), (129, 4864, 897), (1025, 4864, 897)]


@pytest.mark.parametrize("M,K,N", K3_CASES)
def test_k3_kernel_vs_plain_and_bitwise_repeatable(card, M, K, N):
    r = np.random.RandomState(M + N)
    a = torch.from_numpy(r.standard_normal((M, K)).astype(np.float32)).to(card)
    b = torch.from_numpy(r.standard_normal((K, N)).astype(np.float32)).to(card)
    before = kab.matmul_launch_count.n
    got = kab.matmul_kernel(a, b)
    again = kab.matmul_kernel(a, b)
    want = kab.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert kab.matmul_launch_count.n == before + 2
    # true f32 in another summation order: ~1e-6 of the largest value
    # (TF32 would show ~1e-3)
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= 1e-5, err
    assert torch.equal(got, again)          # no split-K, no atomics
    # the same ascending-k fmaf chain as the first (SIMT) body: same bits
    assert torch.equal(got, kab.matmul_simt_oracle(a, b))
    assert kab.matmul_launch_count.n == before + 2


def test_k3_encoded_product_verifies_clean_and_corrects_a_flip(card):
    r = np.random.RandomState(5)
    a = torch.from_numpy(r.standard_normal((130, 96)).astype(np.float32)).to(card)
    b = torch.from_numpy(r.standard_normal((96, 70)).astype(np.float32)).to(card)
    clean, rep = kab.abft_matmul(a, b)
    assert not bool(rep.detected)
    spec = InjectionSpec(leaf_idx=0, flat_idx=3 * 71 + 4, bit=22, step=0,
                         target="kernel")
    torch.cuda.set_sync_debug_mode("error")   # encode/verify never sync
    try:
        c, frep = kab.abft_matmul(
            a, b, inject=make_kernel_fault(spec, step=0, armed=True))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(frep.corrected) and not bool(frep.uncorrectable)
    torch.testing.assert_close(c, clean, atol=1e-3, rtol=0)


# (B, H, KV, Sq, Sk, hd, causal): GQA, ragged tiles (S not a multiple of 64)
K4_CASES = [
    (2, 4, 2, 20, 20, 16, True),
    (1, 4, 1, 37, 37, 16, False),
    (1, 4, 2, 20, 33, 16, False),
    (2, 14, 2, 130, 130, 64, True),
    (1, 2, 1, 150, 150, 64, False),
]


# qwen2-0.5b prefill shapes: B 4, H 14, KV 2, hd 64, causal
K4_MODEL_CASES = [(4, 14, 2, 256, 256, 64, True),
                  (4, 14, 2, 2048, 2048, 64, True)]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", K4_CASES + K4_MODEL_CASES)
def test_k4_kernel_vs_plain(card, B, H, KV, Sq, Sk, hd, causal):
    r = np.random.RandomState(Sq + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                ).to(card)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    v_aug = attention_checksum_encode(v)
    before = kab.flash_ck_launch_count.n
    got = kab.flash_attention_ck(q, k, v_aug, causal=causal)
    again = kab.flash_attention_ck(q, k, v_aug, causal=causal)
    want = kfa.flash_attention_plain(q, k, v_aug, causal=causal)
    torch.cuda.synchronize()
    assert kab.flash_ck_launch_count.n == before + 2
    assert got.shape == (B, H, Sq, hd + 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)        # no split-KV, no atomics
    _, rep = attention_verify(got, Sk)
    assert not bool(rep.detected)
    flat = int(got[..., :hd].abs().argmax())     # the largest data lane
    spec = InjectionSpec(leaf_idx=0,
                         flat_idx=flat // hd * (hd + 1) + flat % hd,
                         bit=23, step=0, target="kernel")
    fault = make_kernel_fault(spec, step=0, armed=True)
    _, frep = attention_verify(fault(got), Sk)
    assert bool(frep.detected) and bool(frep.uncorrectable)
    out, rep = kab.abft_flash_attention(q, k, v, causal=causal)
    assert not bool(rep.detected)
    torch.testing.assert_close(out, want[..., :hd], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "padded", "offset"])
@pytest.mark.parametrize("window", [0, 100])
def test_k4_takes_any_v_aug_view(card, layout, window):
    """v_aug rows of hd + 1 floats are read with 4-byte copies: the plain
    (…, hd + 1) tensor, a view of a buffer padded to hd + 4 and a view that
    starts 4 bytes past a 16-byte boundary give the same bits."""
    B, H, KV, S, hd = 2, 4, 2, 200, 64
    r = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                ).to(card)
               for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    v_aug = attention_checksum_encode(v)
    if layout == "padded":
        buf = torch.zeros(B, KV, S, hd + 4, device=card)
        buf[..., :hd + 1] = v_aug
        view = buf[..., :hd + 1]
    elif layout == "offset":
        buf = torch.zeros(v_aug.numel() + 1, device=card)
        view = buf[1:].view(v_aug.shape)
        view.copy_(v_aug)
        assert view.data_ptr() % 16 == 4
    else:
        view = v_aug
    got = kab.flash_attention_ck(q, k, view, causal=True, window=window)
    want = kfa.flash_attention_plain(q, k, v_aug, causal=True, window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, kab.flash_attention_ck(q, k, v_aug, causal=True,
                                                   window=window))


def test_k4_refuses_an_unaligned_q_without_launch(card):
    buf = torch.zeros(2 * 64 * 64 + 1, device=card)
    q = buf[1:].view(1, 2, 64, 64)
    k = torch.zeros(1, 2, 64, 64, device=card)
    before = kab.flash_ck_launch_count.n
    with pytest.raises(ValueError, match="16-byte aligned"):
        kab.flash_attention_ck(q, k, attention_checksum_encode(k))
    assert kab.flash_ck_launch_count.n == before


def test_reduced_abft_generate_on_the_card_equals_the_cpu_path(card):
    """f32 reduced model: the replica-free abft and hybrid servers on the
    card emit the CPU path's tokens, with one verdict read per step and no
    device read outside `hostsync`."""
    from repro_torch.configs import SedarConfig
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              attention_impl="pallas")
    rc = RunConfig(model=cfg, sedar=SedarConfig(param_validate_interval=2))
    steps = 6
    prompt = np.random.RandomState(0).randint(0, 200, (2, 8))
    cpu = make_server(rc, backend="abft", device="cpu")
    params = cpu.model.init(seed=0)
    want, _ = cpu.generate(params, {"tokens": prompt}, steps=steps)
    gparams = tree_map(lambda t: t.to(card), params)
    gprompt = torch.from_numpy(prompt).to(card)
    for backend in ("abft", "hybrid"):
        srv = make_server(rc, backend=backend, device=card)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with hostsync.count_transfers() as st:
                toks, rep = srv.generate(gparams, {"tokens": gprompt},
                                         steps=steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        np.testing.assert_array_equal(toks, want)
        assert not rep.detections
        assert st.by_label["abft_verdict"] == steps - 1
        assert st.by_label["token_emit"] == steps



@pytest.mark.parametrize("arch", ["xlstm-125m", "seamless-m4t-medium"])
def test_reduced_ssm_and_audio_generate_on_the_card(card, arch):
    """The ssm (mLSTM + sLSTM) and audio (encoder-decoder, K2 on the
    decoder's prefill) families, f32 reduced: the unprotected and the
    sequential servers on the card emit the same tokens, with no detection
    and no device read outside `hostsync`."""
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              attention_impl="pallas")
    rng = np.random.RandomState(0)
    prompt = {"tokens": torch.from_numpy(rng.randint(0, 200, (2, 16)))}
    if cfg.frontend:
        prompt["frontend_embeds"] = torch.from_numpy((0.1 * rng.standard_normal(
            (2, cfg.frontend_seq, cfg.frontend_dim))).astype(np.float32))
    params = make_server(RunConfig(model=cfg), device="cpu").model.init(0)
    gparams = tree_map(lambda t: t.to(card), params)
    gprompt = tree_map(lambda t: t.to(card), prompt)
    out = {}
    for backend in ("none", "sequential"):
        srv = make_server(RunConfig(model=cfg), backend=backend, device=card)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out[backend] = srv.generate(gparams, gprompt, steps=6)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(out["none"][0], out["sequential"][0])
    assert not out["sequential"][1].detections
    assert not out["sequential"][1].stopped


def test_slot_fingerprints_make_one_k1_launch_call_per_row(card):
    """Continuous serving's per-slot fingerprints: one K1 wrapper call and
    one host launch call per row, the bf16 rows read in place, hash words
    equal to the plain version's; inactive rows zeroed."""
    from repro_torch.core.fingerprint import (fingerprint_in_place,
                                              slot_fingerprints)
    logits = (torch.randn(4, 151_936, device=card) * 3).bfloat16()
    active = torch.tensor([True, False, True, True], device=card)
    before = kfp.launch_count.n
    got = slot_fingerprints(logits, active)
    assert kfp.launch_count.n == before + 4
    calls, names = _launches(lambda: fingerprint_in_place([logits[2]]))
    assert calls == 1 and len(names) <= 1
    want = slot_fingerprints(logits.cpu(), active.cpu())
    np.testing.assert_array_equal(got[:, :2].cpu().numpy(),
                                  want[:, :2].numpy())
    assert not got[1].any()


def test_lanes_go_through_k1_on_strided_row_views(card):
    """A pack's lanes: one K1 call per row over the row's strided cache
    views and its logits row, bitwise equal (hash words) to packing the row
    and hashing with the plain version."""
    from repro_torch.core.fingerprint import (lane_fingerprints,
                                              pack_tree_u32)
    L, K, T, KV, hd, V = 3, 4, 40, 2, 64, 1000
    cache = {n: torch.randn(L, K, T, KV, hd, device=card).bfloat16()
             for n in "kv"}
    rows = {n: c.transpose(0, 1).unsqueeze(2) for n, c in cache.items()}
    logits = torch.randn(K, V, device=card)
    before = kfp.launch_count.n
    got = lane_fingerprints(logits, rows)
    assert kfp.launch_count.n == before + K
    for i in range(K):
        packed = pack_tree_u32({"cache": {n: r[i].contiguous()
                                          for n, r in rows.items()},
                                "logits": logits[i]})
        want = kfp.fingerprint_plain(packed)
        assert torch.equal(got[i, :2], want[:2])


def test_small_serve_on_the_card_equals_the_cpu_port(card):
    """Continuous serving of the reduced f32 model on the card (packed
    admission through K1 lanes and K2, slot fingerprints through K1) emits
    the CPU port's streams at lag 1 and lag 4, under sync-debug "error"."""
    from repro_torch.runtime.scheduler import synthetic_requests
    from repro_torch.runtime.serve import SedarServer
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              attention_impl="pallas")
    rc = RunConfig(model=cfg)

    def reqs():
        return synthetic_requests(5, arrival_rate=2.0, prompt_lengths=(4, 8),
                                  max_new_choices=(4, 8), seed=1)

    cpu = SedarServer(rc, dual=True, device="cpu")
    params = cpu.model.init(seed=0)
    want = {r.rid: list(r.tokens) for r in cpu.serve(params, reqs(),
                                                     slots=3)[0]}
    gparams = tree_map(lambda t: t.to(card), params)
    srv = SedarServer(rc, dual=True, device=card)
    for lag in (1, 4):
        before = (kfp.launch_count.n, kfa.launch_count.n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, rep = srv.serve(gparams, reqs(), slots=3, validate_lag=lag)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert {r.rid: list(r.tokens) for r in out} == want
        assert not rep.detections
        assert kfp.launch_count.n - before[0] >= 2 * 3 * rep.steps
        assert kfa.launch_count.n - before[1] == \
            2 * cfg.num_layers * rep.prefill_packs


@pytest.mark.parametrize("n_slots,dtype", [(4, torch.bfloat16),
                                           (1, torch.bfloat16),
                                           (3, torch.float32)])
def test_k1_row_limit_leaves_bitwise_vs_plain(card, n_slots, dtype):
    """Hybrid serve's resident baseline: one K1 launch over every slot's
    cache rows [0, pos[i]) (limits read on the device, int64 and int32)
    and the tokens, bitwise equal (h1, h2, absmax) to the plain version and
    to a masked copy; pos values at 0, mid-run, the run's end and past it."""
    from repro_torch.core.fingerprint import (pack_tree_u32,
                                              slot_rows_fingerprint)
    L, T, KV, hd = 3, 41, 2, 64
    gen = torch.Generator(device=card).manual_seed(n_slots)
    cache = {n: torch.randn(L, n_slots, T, KV, hd, generator=gen,
                            device=card).to(dtype) for n in "kv"}
    pos = torch.tensor([0, 17, T, T + 5][:n_slots], device=card)
    tok = torch.arange(n_slots, device=card)[:, None]
    for p in (pos, pos.to(torch.int32)):
        before = kfp.launch_count.n
        got = slot_rows_fingerprint(cache, p, tok)
        assert kfp.launch_count.n == before + 1
        want = slot_rows_fingerprint({n: c.cpu() for n, c in cache.items()},
                                     p.cpu(), tok.cpu())
        g = got.cpu().numpy().view(np.uint32)
        w = want.numpy().view(np.uint32)
        np.testing.assert_array_equal(g[[0, 1, 3]], w[[0, 1, 3]])
        masked = []
        for name in sorted(cache):
            for i in range(n_slots):
                x = cache[name][:, i].float().cpu().clone()
                x[:, min(int(p[i]), T):] = 0
                masked.append(x)
        m = kfp.fingerprint_plain(pack_tree_u32(masked + [tok.cpu()]))
        np.testing.assert_array_equal(g[:2], m.numpy().view(np.uint32)[:2])
        assert torch.equal(got, slot_rows_fingerprint(cache, p, tok))
    calls, names = _launches(lambda: slot_rows_fingerprint(cache, pos, tok))
    assert calls == 1 and len(names) <= 1


@pytest.mark.parametrize("dtype,kv,hd", [(torch.bfloat16, 1, 12),
                                          (torch.bfloat16, 2, 64),
                                          (torch.float32, 1, 7)])
def test_k1_ring_rows_bitwise_vs_plain(card, dtype, kv, hd):
    """Hybrid serve's baseline of a ring cache (W = 8 rows): one K1 launch
    over each slot's live rows but pos[i] % W, beside a whole recurrent
    state, bitwise equal (h1, h2, absmax) to the plain version and to a
    masked copy; rows of 12 and 7 elements put the skipped row across the
    kernel's 16-byte chunks."""
    from repro_torch.core.fingerprint import (pack_tree_u32,
                                              slot_rows_fingerprint)
    W, n_slots = 8, 4
    gen = torch.Generator(device=card).manual_seed(hd)
    ring = torch.randn(2, n_slots, W, kv, hd, generator=gen,
                       device=card).to(dtype)
    state = torch.randn(2, n_slots, 5, generator=gen, device=card)
    cache = {"a": {"k": ring}, "b": {"h": state}}
    kw = {"roles": {"a": {"k": "ring"}, "b": {"h": "whole"}},
          "axes": {"a": {"k": 1}, "b": {"h": 1}}, "window": W}
    pos = torch.tensor([0, 5, W, 2 * W + 3], device=card)
    tok = torch.arange(n_slots, device=card)[:, None]
    for p in (pos, pos.to(torch.int32)):
        before = kfp.launch_count.n
        got = slot_rows_fingerprint(cache, p, tok, **kw)
        assert kfp.launch_count.n == before + 1
        want = slot_rows_fingerprint(
            tree_util.tree_map(lambda t: t.cpu(), cache), p.cpu(), tok.cpu(),
            **kw)
        g = got.cpu().numpy().view(np.uint32)
        np.testing.assert_array_equal(g[[0, 1, 3]],
                                      want.numpy().view(np.uint32)[[0, 1, 3]])
        masked = ring.float().cpu().clone()
        for i, q in enumerate(p.tolist()):
            for r in range(W):
                if r >= q or r == q % W:
                    masked[:, i, r] = 0
        m = kfp.fingerprint_plain(pack_tree_u32(
            [[masked[:, i] for i in range(n_slots)], state.cpu(), tok.cpu()]))
        np.testing.assert_array_equal(g[:2], m.numpy().view(np.uint32)[:2])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
                                  "xlstm-125m"])
def test_small_family_serve_on_the_card_equals_the_cpu_port(card, arch):
    """Continuous serving of a reduced f32 moe, hybrid or ssm model on the
    card under sequential, fused and hybrid, at lag 1 under sync-debug
    "error", emits the CPU port's sequential streams."""
    from repro_torch.runtime.scheduler import synthetic_requests
    from repro_torch.runtime.serve import SedarServer
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              attention_impl="pallas")
    rc = RunConfig(model=cfg)

    def reqs():
        return synthetic_requests(5, arrival_rate=2.0, prompt_lengths=(8, 16),
                                  max_new_choices=(4, 8), seed=1)

    cpu = SedarServer(rc, dual=True, device="cpu")
    params = cpu.model.init(seed=0)
    want = {r.rid: list(r.tokens) for r in cpu.serve(params, reqs(),
                                                     slots=3)[0]}
    gparams = tree_util.tree_map(lambda t: t.to(card), params)
    for backend in ("sequential", "fused", "hybrid"):
        srv = SedarServer(rc, backend=backend, device=card)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, rep = srv.serve(gparams, reqs(), slots=3, validate_lag=1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert {r.rid: list(r.tokens) for r in out} == want, backend
        assert not rep.detections


def test_fused_step_rows_agree_bitwise_on_the_card(card):
    """A clean fused decode of the reduced model on the card: rows i and
    N + i of the stacked (2N, V) logits are bit-identical (the detection
    needs it) and equal to a replica decoded alone (the attention runs per
    half), and a fused serve under sync-debug "error" emits the sequential
    lag-1 streams at lag 1 and 4."""
    from repro_torch.runtime.scheduler import synthetic_requests
    from repro_torch.runtime.serve import SedarServer
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              attention_impl="pallas")
    rc = RunConfig(model=cfg)
    cpu = SedarServer(rc, dual=True, device="cpu")
    gparams = tree_map(lambda t: t.to(card), cpu.model.init(seed=0))
    srv = SedarServer(rc, backend="fused", device=card)
    n, max_len = 3, 24
    prompt = torch.randint(0, 200, (n, 8), device=card)
    logits, cache = srv.model.prefill(gparams, {"tokens": prompt}, max_len)
    stacked = srv.engine.executor.init_dual(
        {"cache": cache, "tok": torch.argmax(logits, dim=-1), "pos": 8})["s"]
    alone, _ = srv.model.decode_step(
        gparams, {k: c.clone() for k, c in cache.items()},
        torch.argmax(logits, dim=-1), 8)
    out, _ = srv._fused_forward(gparams, stacked["cache"], stacked["tok"], 8,
                                step=8, armed=False, skip=())
    assert torch.equal(out[:n], out[n:])
    assert torch.equal(out[:n], alone)   # a replica decoded alone

    def reqs():
        return synthetic_requests(5, arrival_rate=2.0, prompt_lengths=(4, 8),
                                  max_new_choices=(4, 8), seed=1)

    seq = SedarServer(rc, dual=True, device=card)
    want = {r.rid: list(r.tokens)
            for r in seq.serve(gparams, reqs(), slots=n, validate_lag=1)[0]}
    for lag in (1, 4):
        before = kfp.launch_count.n
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, rep = srv.serve(gparams, reqs(), slots=n, validate_lag=lag)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert {r.rid: list(r.tokens) for r in got} == want
        assert not rep.detections
        assert kfp.launch_count.n - before >= 2 * n * rep.steps


def _trainer(card, cfg, workdir, sedar, spec=None, steps=6, seq=16):
    from repro_torch.configs import SedarConfig, TrainConfig
    from repro_torch.core.policy import make_trainer
    rc = RunConfig(model=cfg, train=TrainConfig(
        global_batch=4, seq_len=seq, steps=steps, warmup_steps=2, lr=1e-3),
        sedar=SedarConfig(**sedar))
    return make_trainer(rc, str(workdir), inj_spec=spec,
                        notify=lambda e: None, device=card)


def test_full_width_training_step_replicas_agree_bitwise(card, tmp_path):
    """qwen2-0.5b at full width: two replicas' backward passes on the same
    params and batch give bitwise equal grads (the embedding's index
    accumulate, the gold-logit gather and the bf16 GEMMs are deterministic
    under deterministic algorithms), K1 in place on the grads equals its
    plain version, and one protected step detects nothing."""
    tr = _trainer(card, get_config("qwen2-0.5b"), tmp_path,
                  dict(level=1, replication="sequential"), steps=1, seq=256)
    state = tr.init_state(seed=0)
    batch = tr.batch(0)
    loss0, g0 = tr.loss_and_grads(state["params"], batch)
    loss1, g1 = tr.loss_and_grads(state["params"], batch)
    assert torch.equal(loss0, loss1) and bool(torch.isfinite(loss0))
    for a, b in zip(tree_util.leaves(g0), tree_util.leaves(g1)):
        assert torch.equal(a, b)
    table = kfp.leaf_table(tree_util.leaves(g0))
    got = tfp.pytree_fingerprint_fused(g0).cpu().numpy()
    want = kfp.fingerprint_leaves_plain(table).cpu().numpy()
    assert np.array_equal(got[[0, 1, 3]], want[[0, 1, 3]])
    del g1
    before = kfp.launch_count.n
    _, rep = tr.run(1, dual=tr.engine.executor.init_dual(state))
    assert not rep.detections and rep.steps_completed == 1
    assert kfp.launch_count.n - before >= 2


def test_l3_fault_run_ends_equal_to_its_clean_run(card, tmp_path):
    """paper-testapp on the card, L3: a grads fault at step 3 is detected,
    restored from the validated checkpoint of step 2 (the card digests its
    leaves with K1 and checks them again on restore), and the run ends
    bitwise equal to the clean one."""
    cfg = get_config("paper-testapp")
    sedar = dict(level=3, replication="sequential", validate_interval=1,
                 param_validate_interval=2, checkpoint_interval=2)
    clean = _trainer(card, cfg, tmp_path / "clean", sedar)
    state = clean.init_state(seed=0)
    _, crep = clean.run(6, dual=clean.engine.executor.init_dual(state))
    spec = InjectionSpec(leaf_idx=0, flat_idx=5, bit=20, step=3, replica=1,
                         target="grads")
    fault = _trainer(card, cfg, tmp_path / "fault", sedar, spec)
    _, frep = fault.run(6, dual=fault.engine.executor.init_dual(state))
    assert not crep.detections and crep.checkpoints == [2, 4, 6]
    assert [(e.step, e.boundary) for e in frep.detections] == [(3, "commit")]
    assert [(r["kind"], r["step"]) for r in frep.recoveries] == \
        [("restore", 2)]
    assert np.array_equal(frep.final_state_fp[:, :2],
                          crep.final_state_fp[:, :2])
    assert frep.losses == crep.losses


def test_checkpoint_digests_on_the_card_equal_the_host_digests(card,
                                                               tmp_path):
    """A state on the card is digested by K1 (one launch per word leaf)
    and equals numpy's digest of the same bytes; a restore onto the card
    returns the bits and rejects a corrupted leaf."""
    import os
    from repro_torch.checkpoint import store as cstore
    gen = torch.Generator(device=card).manual_seed(3)
    state = {"w": torch.randn(1000, 33, generator=gen, device=card),
             "n": torch.arange(7, dtype=torch.int32, device=card),
             "s": torch.zeros((), dtype=torch.int32, device=card)}
    host, digests = cstore.snapshot(state)
    assert digests == [cstore._leaf_digest(a) for a in host]
    st = cstore.CheckpointStore(str(tmp_path / "ck"))
    st.save(1, state)
    back = st.restore(1, state)
    for a, b in zip(tree_util.leaves(back), tree_util.leaves(state)):
        assert a.is_cuda and torch.equal(a, b)
    path = os.path.join(st.dir, "ckpt_00000001", "leaf_00000.npy")
    arr = np.load(path)
    arr[0] ^= 1
    np.save(path, arr)
    with pytest.raises(cstore.CheckpointCorruptionError):
        st.restore(1, state)


def test_fused_full_width_grads_replicas_agree_bitwise(card, tmp_path):
    """qwen2-0.5b at full width under fused: the vmapped backward of the
    stacked replicas gives bitwise equal grads in both replicas' slices,
    and K1 on each replica's view (in place, one launch each) equals its
    plain version and the other view's words."""
    from repro_torch.core.engine import replica_view
    tr = _trainer(card, get_config("qwen2-0.5b"), tmp_path,
                  dict(level=1, replication="fused"), steps=1, seq=256)
    state = tr.init_state(seed=0)
    dual = tr.engine.executor.init_dual(state)
    del state
    losses, grads = tr.loss_and_grads_stacked(dual["s"]["params"],
                                              tr.batch(0))
    del dual
    assert torch.equal(losses[0], losses[1])
    views = [replica_view(grads, r) for r in range(2)]
    for a, b in zip(tree_util.leaves(views[0]), tree_util.leaves(views[1])):
        assert torch.equal(a, b)
    words = []
    for v in views:
        table = kfp.leaf_table(tree_util.leaves(v))
        before = kfp.launch_count.n
        got = tfp.pytree_fingerprint_fused(v).cpu().numpy()
        assert kfp.launch_count.n == before + 1
        want = kfp.fingerprint_leaves_plain(table).cpu().numpy()
        assert np.array_equal(got[[0, 1, 3]], want[[0, 1, 3]])
        words.append(got)
    assert np.array_equal(words[0], words[1])


def test_device_tier_restore_reads_no_disk(card, tmp_path):
    """paper-testapp on the card, L3 with the device, host and disk tiers:
    the grads fault restores from the device ring with 0 disk reads and 0
    host reads, and the run ends bitwise equal to its flat-disk clean
    run."""
    from repro_torch.checkpoint import count_disk_reads
    cfg = get_config("paper-testapp")
    sedar = dict(level=3, replication="sequential", validate_interval=1,
                 param_validate_interval=2, checkpoint_interval=2)
    clean = _trainer(card, cfg, tmp_path / "clean", sedar)
    state = clean.init_state(seed=0)
    _, crep = clean.run(6, dual=clean.engine.executor.init_dual(state))
    spec = InjectionSpec(leaf_idx=0, flat_idx=5, bit=20, step=3, replica=1,
                         target="grads")
    tiered = _trainer(card, cfg, tmp_path / "tiers",
                      dict(sedar, ckpt_tiers="device,host,disk"), spec)
    counted = {}
    restore = tiered.recovery.restore

    def counting(action, template):
        with count_disk_reads() as dr, hostsync.count_transfers() as ht:
            out = restore(action, template)
        counted.update(disk=dr.reads, host=ht.transfers)
        return out

    tiered.recovery.restore = counting
    _, rep = tiered.run(6, dual=tiered.engine.executor.init_dual(state))
    assert counted == {"disk": 0, "host": 0}
    assert rep.restored_from == ["device"]
    assert np.array_equal(rep.final_state_fp[:, :2],
                          crep.final_state_fp[:, :2])
    assert rep.losses == crep.losses


@pytest.mark.parametrize("window,proc,datum,effect", [
    ("SCATTER", "W", "A", "TDC"),
    ("GATHER", "M", "C", "FSC"),
    ("CK2", "W", "i", "TOE"),
])
def test_campaign_row_at_n4096(card, window, proc, datum, effect):
    """The replica campaign with 64 MB matrices on the card: the row
    matches `predict`, the result is within the f32 bound of the f64
    truth, and the recovered C equals the clean run's bitwise."""
    from repro_torch.core.scenarios import (MatmulTestApp, all_scenarios,
                                            campaign_row)
    app = MatmulTestApp(n=4096, workers=2, device=card)
    app.run(None)
    clean = [m["M.C"].clone() for m in app.last_mem]
    s = next(x for x in all_scenarios()
             if (x.window, x.process, x.datum) == (window, proc, datum))
    row = campaign_row(s, app.run(s))
    assert row["match"] and row["obs"]["effect"] == effect
    assert all(torch.equal(m["M.C"], c) for m, c in zip(app.last_mem, clean))


def _telemetry_serve(srv, params, reqs, lag, on):
    """One serve() under sync-debug "error", telemetry off or on (metrics,
    journal, trace and a serve-mode autotuner that never applies) -> (out,
    report, host reads, (K1, K2) launches, journal records, tuner)."""
    from repro_torch import obs
    from repro_torch.core import temporal_model as tm
    from repro_torch.core.policy import Autotuner, AutotuneConfig
    tuner = journal = None
    if on:
        obs.enable_metrics()
        journal = obs.FaultJournal()
        obs.set_journal(journal)
        obs.enable_trace()
        tuner = Autotuner(tm.PAPER_TABLE3["JACOBI"], AutotuneConfig(
            interval_steps=2, mode="serve", persistence=10 ** 6))
    before = (kfp.launch_count.n, kfa.launch_count.n)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with hostsync.count_transfers(cross_thread=True) as st:
            out, rep = srv.serve(params, reqs(), slots=3, validate_lag=lag,
                                 autotune=tuner)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        records = journal.records() if journal is not None else []
        obs.disable_metrics()
        obs.set_journal(None)
        obs.disable_trace()
        obs.shutdown()
    launches = (kfp.launch_count.n - before[0], kfa.launch_count.n - before[1])
    return out, rep, st.by_label, launches, records, tuner


def _full_width_server(card, **kw):
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              attention_impl="pallas")
    return make_server(RunConfig(model=cfg), dual=True, device=card, **kw)


def _short_requests():
    from repro_torch.runtime.scheduler import synthetic_requests
    return synthetic_requests(3, arrival_rate=1.0, prompt_lengths=(16, 40),
                              max_new_choices=(6, 10), vocab=151936, seed=2)


@pytest.mark.parametrize("lag", [1, 8])
def test_telemetry_adds_no_read_or_launch_at_full_width(card, lag):
    """qwen2-0.5b at full width, 3 short requests: with the telemetry loop
    on, the same host reads by label, the same K1 and K2 launches and the
    same tokens as with it off."""
    srv = _full_width_server(card)
    params = srv.model.init(seed=0)
    off = _telemetry_serve(srv, params, _short_requests, lag, False)
    on = _telemetry_serve(srv, params, _short_requests, lag, True)
    assert not off[1].detections and not on[1].detections
    assert on[2] == off[2]
    assert on[3] == off[3] and off[3][0] > 0 and off[3][1] > 0
    assert {r.rid: list(r.tokens) for r in on[0]} == \
        {r.rid: list(r.tokens) for r in off[0]}
    assert on[5].evaluations > 0


def test_journaled_slot_fault_reconciles_at_full_width(card):
    """The lag-8 slot fault (slot 1's bf16 logits, bit 14, tick 3): one
    deferred detection rolled back, and the journal reproduces the
    engine's detections, recoveries, alerts and reconfigs."""
    from repro_torch import obs
    spec = InjectionSpec(leaf_idx=1, flat_idx=7, bit=14, step=3, replica=1,
                         target="slot")
    srv = _full_width_server(card, inj_spec=spec)
    params = srv.model.init(seed=0)
    out, rep, _, _, records, tuner = _telemetry_serve(
        srv, params, _short_requests, 8, True)
    (eng, _, _), = srv._batch_engines.values()
    assert [(e.step, e.boundary, e.detail.get("slots"))
            for e in rep.detections] == [(3, "deferred", [1])]
    assert rep.rollbacks == 1 and len(rep.completed) == 3
    assert obs.reconcile(records, eng.detections, eng.recoveries,
                         alerts=tuner.alerts.records,
                         reconfigs=eng.reconfigs) == {
        "detections_match": True, "recoveries_match": True,
        "alerts_match": True, "reconfigs_match": True}


@pytest.mark.parametrize("window", [0, 96])
def test_chunked_attention_on_the_card_matches_exact(card, window):
    """The chunked causal and windowed forms on CUDA tensors (f32, no TF32)
    against the exact (S, S) form: outputs and grads within 2e-5, at a
    ragged length past CHUNKED_THRESHOLD for the causal form."""
    from repro_torch.models import layers as nn
    S = nn.CHUNKED_THRESHOLD + 60 if not window else 300
    gen = torch.Generator(device="cuda").manual_seed(window)
    q, k, v, ct = (torch.randn((1, S, n, 64), generator=gen, device=card)
                   for n in (4, 2, 2, 4))
    fn = (nn.chunked_causal_attention if not window else
          lambda a, b, c: nn.chunked_window_attention(a, b, c, window,
                                                      q_chunk=128))
    res = []
    for f in (fn, lambda a, b, c: nn.causal_attention(a, b, c, window)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = f(*leaves)
        res.append([out] + list(torch.autograd.grad((out * ct).sum(),
                                                    leaves)))
    for a, b in zip(*res):
        assert float((a - b).abs().max()) <= 2e-5


def test_non_finite_residual_is_uncorrectable_on_the_card(card):
    """F3 on CUDA tensors: a NaN element of a checksummed product fails its
    row and column and is flagged uncorrectable, with no host read."""
    from repro_torch.abft.ref import checksum_encode, verify_and_correct
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((6, 32), generator=gen, device=card)
    b = torch.randn((32, 5), generator=gen, device=card)
    c_full = torch.matmul(*checksum_encode(a, b))
    c_full[2, 3] = float("nan")
    with hostsync.count_transfers() as st:
        _, rep = verify_and_correct(c_full, 32)
    assert st.transfers == 0
    assert bool(rep.detected) and bool(rep.uncorrectable)
    assert not bool(rep.corrected)
