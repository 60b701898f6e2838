"""The numerical design of K2's bf16 tensor-core kernel, on the CPU.

The kernel (`src/repro_torch/csrc/flash_attention.cu`, `flash_fwd_wgmma`)
runs only on the card. This file emulates its arithmetic in PyTorch:
bf16 q.k^T products summed in f32, the scale applied to the f32 scores, an
f32 online softmax over 64-key tiles in log2 units, P split into bf16
hi + lo for two bf16 P.V products accumulated in f32, and a bf16 output.
The emulation is held against the reference's Pallas kernel in interpret
mode on the same bf16 inputs, with the card checks' tolerance (atol 1e-3 +
rtol 8e-3 elementwise: one bf16 rounding step is at most 2^-7 of the
value). It also records why P is split: with P rounded once to bf16 the
f32 result is at least 10x further from the reference than with hi + lo.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas

torch.set_num_threads(1)

TILE = 64
B, H, KV = 1, 4, 2
# (S, hd, window), all causal
CASES = [(64, 16, 0), (64, 64, 0), (130, 16, 0), (130, 64, 0),
         (130, 16, 40), (130, 64, 40)]


def _emulate(q, k, v, *, window: int, split_p: bool) -> torch.Tensor:
    """The kernel's arithmetic on bf16 q (B,H,S,hd), k/v (B,KV,S,hd); returns
    the f32 output before its bf16 rounding."""
    _, nh, S, hd = q.shape
    group = nh // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = torch.tensor((1.0 / math.sqrt(hd)) * 1.4426950408889634,
                              dtype=torch.float32)
    qpos = torch.arange(S)[:, None]
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, S, TILE):
        kpos = torch.arange(k0, min(k0 + TILE, S))[None, :]
        # bf16 x bf16 is exact in f32; the sum is f32
        t = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + TILE]) \
            * scale_log2
        ok = qpos >= kpos
        if window:
            ok = ok & (qpos - kpos < window)
        t = torch.where(ok, t, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, t.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()] if split_p else [hi]
        acc = acc * corr[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", part,
                                     vf[:, :, k0:k0 + TILE])
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return acc * inv[..., None]


def _inputs(S, hd):
    r = np.random.RandomState(S + hd)
    return [torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                             ).bfloat16()
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


def _pallas(q, k, v, window, dtype):
    out = flash_attention_pallas(
        *(jnp.asarray(t.float().numpy(), dtype=dtype) for t in (q, k, v)),
        causal=True, window=window, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("S,hd,window", CASES)
def test_emulated_kernel_matches_pallas_in_bf16(S, hd, window):
    q, k, v = _inputs(S, hd)
    got = _emulate(q, k, v, window=window, split_p=True).bfloat16().float()
    want = _pallas(q, k, v, window, jnp.bfloat16)
    assert got.shape == want.shape == (B, H, S, hd)
    excess = (got - want).abs() - (1e-3 + 8e-3 * want.abs())
    assert float(excess.max()) <= 0.0, float(excess.max())


@pytest.mark.parametrize("S,hd,window", CASES)
def test_split_p_is_ten_times_closer_than_one_bf16_p(S, hd, window):
    """f32 results before the output rounding, against the reference in
    f32 on the same bf16-valued inputs."""
    q, k, v = _inputs(S, hd)
    want = _pallas(q, k, v, window, jnp.float32)
    err_split = float((_emulate(q, k, v, window=window, split_p=True)
                       - want).abs().max())
    err_single = float((_emulate(q, k, v, window=window, split_p=False)
                        - want).abs().max())
    assert err_single >= 10 * err_split, (err_single, err_split)
