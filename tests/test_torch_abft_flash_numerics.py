"""The numerical design of K4's true-f32 kernel, on the CPU.

The kernel (`src/repro_torch/csrc/flash_attention.cu`, `flash_fwd_f32` with
the checksum lane) runs only on the card. This file emulates its order of
arithmetic in f32 PyTorch: 64-row q tiles that visit only the 64-key tiles
some row reaches, f32 scores scaled after the product, the row max over the
16 threads of a row, p = exp(s - m) with a per-thread share of l (thread tx
holds keys tx + 16 j), P through shared memory into P.V, the checksum lane as
one per-thread share of sum_j p * v_aug[key][hd], and the 16 shares of l
and of the lane summed by the kernel's xor-shuffle tree (offsets 1, 2, 4,
8). The emulation is held against the reference's Pallas K4
(`src/repro/abft/kernels.py::abft_flash_attention`) in interpret mode on
the same f32 inputs, within 1e-5 on every lane of out_full, and its clean
checksum verdict must stay silent under the eps32 threshold.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.abft.kernels import abft_flash_attention as j_abft_flash_attention

from repro_torch.abft.ref import attention_checksum_encode, attention_verify

torch.set_num_threads(1)

TILE = 64      # q rows per block and keys per K/V tile
LANES = 16     # threads that share a row
B, H, KV = 1, 4, 2
# (S, hd, causal, window)
CASES = [(64, 16, True, 0), (130, 64, True, 0), (130, 16, True, 40),
         (100, 64, False, 0), (200, 64, True, 0), (200, 16, False, 70)]


def _xor_tree(x: torch.Tensor) -> torch.Tensor:
    """The kernel's shuffle reduction over the last dim (16 lanes): lane t
    adds lane t ^ off for off = 1, 2, 4, 8; every lane ends with the sum."""
    idx = torch.arange(LANES)
    for off in (1, 2, 4, 8):
        x = x + x[..., idx ^ off]
    return x[..., 0]


def _emulate(q, k, v_aug, *, causal: bool, window: int) -> torch.Tensor:
    """K4's arithmetic on f32 q (B,H,S,hd), k (B,KV,S,hd), v_aug
    (B,KV,S,hd+1) -> out_full (B,H,S,hd+1)."""
    nb, nh, Sq, hd = q.shape
    Sk = k.shape[2]
    group = nh // k.shape[1]
    kx = k.repeat_interleave(group, dim=1)
    vx = v_aug.repeat_interleave(group, dim=1)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    out = torch.zeros(nb, nh, Sq, hd + 1)
    for q0 in range(0, Sq, TILE):
        nr = min(TILE, Sq - q0)
        qpos = torch.arange(q0, q0 + nr)[:, None]
        k_lo, k_hi = 0, Sk
        if causal:
            k_hi = min(Sk, q0 + TILE)
        if window > 0:
            k_lo = max(0, q0 - window + 1)
        k_lo = k_lo // TILE * TILE
        m = torch.full((nb, nh, nr), -1e30)
        l = torch.zeros(nb, nh, nr, LANES)       # per-thread shares
        lane = torch.zeros(nb, nh, nr, LANES)
        acc = torch.zeros(nb, nh, nr, hd)
        for k0 in range(k_lo, k_hi, TILE):
            kk = kx[:, :, k0:k0 + TILE]
            vv = vx[:, :, k0:k0 + TILE]
            nk = kk.shape[2]
            if nk < TILE:      # the kernel zero-fills keys past Sk
                kk = torch.cat([kk, torch.zeros(nb, nh, TILE - nk, hd)], 2)
                vv = torch.cat([vv, torch.zeros(nb, nh, TILE - nk, hd + 1)],
                               2)
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q0 + nr], kk) \
                * scale
            kpos = torch.arange(k0, k0 + TILE)[None, :]
            ok = kpos < Sk
            if causal:
                ok = ok & (qpos >= kpos)
            if window > 0:
                ok = ok & (qpos - kpos < window)
            s = torch.where(ok, s, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, s.amax(-1))     # max: any order
            corr = torch.exp(m - m_new)
            m = m_new
            p = torch.exp(s - m[..., None])          # 0 for a masked key
            pj = p.view(nb, nh, nr, 4, LANES)        # key tx + 16 j
            vc = vv[..., hd].reshape(nb, nh, 1, 4, LANES)
            l = l * corr[..., None]
            lane = lane * corr[..., None]
            for j in range(4):                       # the thread's order
                l = l + pj[..., j, :]
                lane = lane + pj[..., j, :] * vc[..., j, :]
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vv[..., :hd])
        lsum = _xor_tree(l)
        inv = torch.where(lsum > 0, 1.0 / lsum, torch.zeros_like(lsum))
        out[:, :, q0:q0 + nr, :hd] = acc * inv[..., None]
        out[:, :, q0:q0 + nr, hd] = _xor_tree(lane) * inv
    return out


def _inputs(S, hd):
    r = np.random.RandomState(S + hd)
    return [r.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


def _pallas_out_full(q, k, v, causal, window) -> torch.Tensor:
    """The reference K4's out_full (all hd + 1 lanes), captured through its
    fault hook before its verify."""
    seen = []
    j_abft_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window,
                           inject=lambda x: seen.append(x) or x,
                           interpret=True)
    return torch.from_numpy(np.array(seen[0]))


@pytest.mark.parametrize("S,hd,causal,window", CASES)
def test_emulated_k4_matches_pallas_and_verifies_clean(S, hd, causal, window):
    q, k, v = _inputs(S, hd)
    v_aug = attention_checksum_encode(torch.from_numpy(v))
    got = _emulate(torch.from_numpy(q), torch.from_numpy(k), v_aug,
                   causal=causal, window=window)
    want = _pallas_out_full(q, k, v, causal, window)
    assert got.shape == want.shape == (B, H, S, hd + 1)
    err = float((got - want).abs().max())
    assert err <= 1e-5, err
    _, rep = attention_verify(got, S)
    assert not bool(rep.detected), float(rep.max_residual)


def test_xor_tree_is_the_kernels_shuffle_order():
    """Every lane of the shuffle tree ends with the same sum; for values
    whose f32 sum depends on the order, the tree's bits are reproduced by
    its explicit pairing ((x0 + x1) + (x2 + x3)) + ... ."""
    x = torch.tensor([1e8, 1.0, -1e8, 1.0] * 4, dtype=torch.float32)
    pairs = x.view(8, 2).sum(-1).view(4, 2).sum(-1).view(2, 2).sum(-1).sum()
    assert torch.equal(_xor_tree(x), pairs)
