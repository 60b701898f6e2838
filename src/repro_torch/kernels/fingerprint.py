"""K1: fused state fingerprint on Hopper, with its plain version beside it.

Replaces `src/repro/kernels/fingerprint.py::fingerprint_pallas` (the
`_fingerprint_kernel` Pallas kernel); the CUDA source is
`src/repro_torch/csrc/fingerprint.cu`, whose header states the bound and the
design. Over a flat buffer of u32 words u_i at element index i:

    h1 = sum_i ((u_i XOR (i*C1)) * C2)        mod 2^32
    h2 = sum_i (t XOR (t >> 15)), t=(u_i+i)*C3 mod 2^32
    s  = sum(float(u_i))  (f32)       a = max(|float(u_i)|)  (f32)

Word carrier: torch has no full uint32 arithmetic, so a buffer of u32 words
travels as an int32 tensor holding the same bits, and a fingerprint is a
(4,) int32 tensor holding the bits of [h1, h2, s, a]. The plain version
widens the words to int64, keeps every intermediate in [0, 2^32), and masks
after each operation; a 32x32-bit product is formed from 16-bit halves of
the constant so that it never leaves the int64 range.

`fingerprint_u32` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (or raises). There is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

C1 = 2654435761
C2 = 2246822519
C3 = 3266489917
MASK32 = 0xFFFFFFFF
THREADS = 256            # csrc/fingerprint.cu THREADS
MAX_BLOCKS = 1024
_PLAIN_CHUNK = 1 << 24   # words per int64 working chunk of the plain version

launch_count = _build.LaunchCount("fingerprint")


def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a constant c < 2^32;
    both partial products stay below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _to_carrier(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def fingerprint_plain(u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1 over a 1-D int32 word buffer -> (4,) int32 carrier.
    Runs on the tensor's device."""
    n = u.numel()
    dev = u.device
    h1 = torch.zeros((), dtype=torch.int64, device=dev)
    h2 = torch.zeros((), dtype=torch.int64, device=dev)
    s = torch.zeros((), dtype=torch.float32, device=dev)
    a = torch.zeros((), dtype=torch.float32, device=dev)
    for start in range(0, n, _PLAIN_CHUNK):
        end = min(start + _PLAIN_CHUNK, n)
        w = u[start:end]
        uc = w.to(torch.int64) & MASK32
        idx = torch.arange(start, end, dtype=torch.int64, device=dev) & MASK32
        h1 = (h1 + _mulmod32(uc ^ _mulmod32(idx, C1), C2).sum()) & MASK32
        t = _mulmod32((uc + idx) & MASK32, C3)
        h2 = (h2 + (t ^ (t >> 15)).sum()) & MASK32
        x = w.view(torch.float32)
        s = s + x.sum()
        a = torch.maximum(a, x.abs().max())
    hashes = _to_carrier(torch.stack([h1, h2]))
    stats = torch.stack([s, a]).view(torch.int32)
    return torch.cat([hashes, stats])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("fingerprint").sedar_fingerprint
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _blocks_for(n: int) -> int:
    """Pass-1 grid: a function of n alone, so the float reduction tree (and
    with it the diagnostic `s`) is the same on every run."""
    return max(1, min(MAX_BLOCKS, -(-n // (THREADS * 16))))


def fingerprint_u32(u: torch.Tensor) -> torch.Tensor:
    """K1 wrapper over a packed word buffer (1-D, int32 carrier or
    torch.uint32, contiguous) -> (4,) int32 carrier."""
    if u.dtype == torch.uint32:
        u = u.view(torch.int32)
    if u.dtype != torch.int32 or u.dim() != 1:
        raise TypeError(f"fingerprint_u32 expects a 1-D int32/uint32 word "
                        f"buffer, got {tuple(u.shape)} {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("fingerprint_u32 needs a contiguous buffer")
    if u.device.type == "cpu":
        return fingerprint_plain(u)
    if u.device.type != "cuda":
        raise RuntimeError(f"no K1 kernel for device {u.device}")
    fn = _launcher()
    n = u.numel()
    nblocks = _blocks_for(n)
    partials = torch.empty((nblocks, 4), dtype=torch.int32, device=u.device)
    out = torch.empty((4,), dtype=torch.int32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), n, partials.data_ptr(), nblocks,
                out.data_ptr(), stream)
    _build.check(rc, "fingerprint")
    launch_count.add()
    return out
