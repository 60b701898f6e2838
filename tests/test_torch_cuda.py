"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, the protected serving path through K1/K2, and the ABFT slice
(K3, K4, a replica-free generate). Every test
here is marked `cuda` and skips without a card. The file imports nothing of
JAX, so it also runs on a machine without it:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.abft import kernels as kab
from repro_torch.abft.ref import attention_checksum_encode
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
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


@pytest.mark.parametrize("n", [0, 1, 127, 128 * 256 + 1, 607_744, 3_000_001])
def test_k1_kernel_bitwise_vs_plain(card, n):
    r = np.random.RandomState(n)
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
    if n > 8:   # a start off the 16-byte boundary takes the scalar head path
        np.testing.assert_array_equal(
            kfp.fingerprint_u32(u[1:]).cpu().numpy().view(np.uint32)[:2],
            kfp.fingerprint_plain(u[1:]).cpu().numpy().view(np.uint32)[:2])


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


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", K4_CASES)
def test_k4_kernel_vs_plain(card, B, H, KV, Sq, Sk, hd, causal):
    r = np.random.RandomState(Sq + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                ).to(card)
               for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    v_aug = attention_checksum_encode(v)
    before = kab.flash_ck_launch_count.n
    got = kab.flash_attention_ck(q, k, v_aug, causal=causal)
    want = kfa.flash_attention_plain(q, k, v_aug, causal=causal)
    torch.cuda.synchronize()
    assert kab.flash_ck_launch_count.n == before + 1
    assert got.shape == (B, H, Sq, hd + 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    out, rep = kab.abft_flash_attention(q, k, v, causal=causal)
    assert not bool(rep.detected)
    torch.testing.assert_close(out, want[..., :hd], atol=1e-5, rtol=1e-5)


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

