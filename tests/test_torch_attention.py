"""Port flash attention (K2's plain version on the CPU, the kernel on the
card) against the reference's Pallas kernel in interpret mode and its
`mha_ref`. Tolerance atol=rtol=1e-5 in f32: the same function summed in
another order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, H, KV, Sq, Sk, hd, causal, window, block): Sq/Sk off the tile sizes
CASES = [
    (2, 4, 2, 20, 20, 16, True, 0, 8),       # GQA, causal
    (1, 4, 1, 37, 37, 16, True, 0, 16),      # GQA 4:1, ragged tiles
    (2, 2, 2, 33, 33, 16, True, 5, 16),      # sliding window
    (1, 4, 2, 20, 33, 16, False, 0, 16),     # non-causal, Sq != Sk
    (1, 2, 1, 24, 24, 64, True, 7, 8),       # hd 64, window + causal
]


def _qkv(B, H, KV, Sq, Sk, hd, seed=0):
    r = np.random.RandomState(seed)
    q = r.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = r.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    v = r.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window,block", CASES)
def test_plain_flash_matches_pallas_and_mha_ref(B, H, KV, Sq, Sk, hd, causal,
                                                window, block):
    q, k, v = _qkv(B, H, KV, Sq, Sk, hd)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=block, block_k=block, interpret=True))
    ref = np.asarray(jref.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window))
    got = kfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window).numpy()
    assert got.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_model_layout_wrapper_matches_reference_ops():
    """kernels.ops.flash_attention: (B,S,H,hd) in and out, as the model
    calls it."""
    q, k, v = _qkv(2, 4, 2, 19, 19, 16, seed=3)
    qm, km, vm = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    want = np.asarray(jops.flash_attention(jnp.asarray(qm), jnp.asarray(km),
                                           jnp.asarray(vm), causal=True))
    got = tops.flash_attention(torch.from_numpy(qm), torch.from_numpy(km),
                               torch.from_numpy(vm), causal=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_path_does_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 8, 8, 16))
    before = kfa.launch_count.n
    kfa.flash_attention_fwd(q, k, v)
    assert kfa.launch_count.n == before

