"""The ABFT subsystem's kernels on Hopper, each with its plain version
beside it (the reference's `abft/kernels.py`).

  * K3 `matmul_kernel` replaces `matmul_pallas` (the `_matmul_kernel` Pallas
    kernel): the f32 product of two matrices, `csrc/abft_matmul.cu`.
    `abft_matmul` runs it on the checksum-encoded operands: encode ->
    K3 -> `inject` -> `verify_and_correct`, with the encode and the verify
    in plain PyTorch outside the kernel, as the reference does them outside
    its Pallas call. Its plain version `matmul_plain` is `torch.matmul` in
    f32 with TF32 off.
  * K4 `flash_attention_ck` replaces the Pallas call in
    `abft_flash_attention`: K2's flash-attention body with V and the output
    widened by a checksum lane, the `CK` variant in
    `csrc/flash_attention.cu`. `abft_flash_attention` runs encode -> K4 ->
    `inject` -> `attention_verify`. Its plain version is
    `flash_attention_plain` on the encoded V (`abft_attention_ref`'s math).

Each wrapper takes its plain version for a CPU tensor, and only then; a
CUDA tensor launches the kernel or raises. The sources' headers state each
kernel's bound and design. Block sizes are the kernels' own (no block
arguments, unlike the reference's Pallas tiling).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.abft.ref import (DEFAULT_TAU_FACTOR, AbftReport,
                                  attention_checksum_encode, attention_verify,
                                  checksum_encode, verify_and_correct)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_plain

matmul_launch_count = _build.LaunchCount("abft_matmul")
flash_ck_launch_count = _build.LaunchCount("abft_flash_attention")


# ---------------------------------------------------------------------------
# K3: checksummed matmul
# ---------------------------------------------------------------------------

def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain K3: the f32 product. On the card it refuses to run with TF32
    on, which would trip the eps32 residual threshold on clean data."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("matmul_plain needs TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    return torch.matmul(a.float(), b.float())


@functools.lru_cache(maxsize=None)
def _matmul_launcher():
    fn = _build.load("abft_matmul").sedar_abft_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: (M, K) x (K, N) f32 -> (M, N) f32, true f32 products in a
    fixed order (bitwise equal from run to run)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("operands on different devices")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"no K3 kernel for device {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"K3 takes float32, got {a.dtype} x {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("K3 needs contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("matrix too large for K3's 32-bit sizes")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = _matmul_launcher()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                M, N, K, stream)
    _build.check(rc, "abft_matmul")
    matmul_launch_count.add()
    return out


def abft_matmul(a: torch.Tensor, b: torch.Tensor, *,
                inject: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                tau_factor: float = DEFAULT_TAU_FACTOR
                ) -> Tuple[torch.Tensor, AbftReport]:
    """Checksummed matmul: encode -> K3 -> inject -> verify/correct.
    `inject` (`injection.make_kernel_fault`) corrupts the full-checksum
    product between compute and verify, inside the protected computation,
    where the checksums are the only detector."""
    a_c, b_r = checksum_encode(a, b)
    c_full = matmul_kernel(a_c, b_r)
    if inject is not None:
        c_full = inject(c_full)
    return verify_and_correct(c_full, a.shape[1], tau_factor)


# ---------------------------------------------------------------------------
# K4: checksummed flash attention
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _flash_ck_launcher():
    fn = _build.load("flash_attention").sedar_abft_flash_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_ck(q, k, v_aug, *, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """K4 wrapper. q: (B,H,Sq,hd), k: (B,KV,Sk,hd), v_aug: (B,KV,Sk,hd+1),
    all f32 -> out_full (B,H,Sq,hd+1) f32, lane hd the checksum lane."""
    if q.dim() != 4 or k.dim() != 4 or v_aug.dim() != 4:
        raise ValueError("K4 expects 4-D q, k, v_aug")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, KV, Sk, hd) or v_aug.shape != (B, KV, Sk, hd + 1):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v_aug {tuple(v_aug.shape)}")
    if H % KV:
        raise ValueError(f"{H} query heads not a multiple of {KV} KV heads")
    if not (q.device == k.device == v_aug.device):
        raise ValueError("q, k, v_aug on different devices")
    if q.device.type == "cpu":
        return flash_attention_plain(q.float(), k.float(), v_aug.float(),
                                     causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no K4 kernel for device {q.device}")
    if not (q.dtype == k.dtype == v_aug.dtype == torch.float32):
        raise TypeError("K4 takes float32 q, k, v_aug")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K4 is built for head_dim in {HEAD_DIMS}, got {hd}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v_aug.stride(3) != 1:
        raise ValueError("K4 needs a contiguous head dim (stride 1)")
    if max(Sq, Sk) >= 2 ** 31:
        raise ValueError("sequence too long for K4's 32-bit positions")
    out = torch.empty((B, H, Sq, hd + 1), dtype=torch.float32,
                      device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v_aug.stride()[:3],
        *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _flash_ck_launcher()(hd, q.data_ptr(), k.data_ptr(),
                                  v_aug.data_ptr(), out.data_ptr(), strides,
                                  B, H, KV, Sq, Sk, int(bool(causal)),
                                  int(window), 1.0 / math.sqrt(hd), stream)
    _build.check(rc, "abft_flash_attention")
    flash_ck_launch_count.add()
    return out


def abft_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                         inject: Optional[Callable] = None,
                         tau_factor: float = DEFAULT_TAU_FACTOR
                         ) -> Tuple[torch.Tensor, AbftReport]:
    """q: (B,H,Sq,hd); k/v: (B,KV,Sk,hd). Returns ((B,H,Sq,hd) f32, report).
    Protects the PV product and the accumulate/normalize path; a QK^T-path
    corruption moves every lane consistently and escapes."""
    q = q.float()
    k = k.float()
    v_aug = attention_checksum_encode(v.float())
    out_full = flash_attention_ck(q, k, v_aug, causal=causal, window=window)
    if inject is not None:
        out_full = inject(out_full)
    return attention_verify(out_full, k.shape[2], tau_factor)
