"""K2: forward flash attention on Hopper, with its plain version beside it.

Replaces `src/repro/kernels/flash_attention.py::flash_attention_pallas` (the
`_flash_kernel` Pallas kernel); the CUDA source is
`src/repro_torch/csrc/flash_attention.cu`, whose header states the bound and
the design. Layout as in the reference kernel: q (B, H, Sq, hd), k/v
(B, KV, Sk, hd) with GQA when KV < H, causal and/or sliding-window masks
from absolute positions, output (B, H, Sq, hd) in q.dtype.

The kernel reads its inputs through strides (only the head dim must be
contiguous), so the model's (B, S, H, hd) tensors are passed as transposed
views without a copy, and it writes its output in (B, Sq, H, hd) memory
order: `kernels.ops.flash_attention` hands the model a contiguous result.

Each input type has one kernel: bf16 runs on the tensor cores (`wgmma`),
f32 in true f32 on the FFMA units (the body K4 shares), each at head dims
16, 64, 128 and 256 (`HEAD_DIMS`). Both copy q, k and
v into shared memory 16 bytes at a time, so they need them 16-byte aligned
with strides that are multiples of 16 bytes (8 bf16 or 4 f32 elements; the
model's tensors are).

`flash_attention_fwd` is the wrapper: a CPU tensor takes the plain version
(`flash_attention_plain`, the counterpart of the reference's
`kernels/ref.py::mha_ref`), a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

# head dims each body is built for (the f32 body is K4's as well; at hd 256
# it keeps one K/V stage to fit the SM's 227 KB, csrc/flash_attention.cu)
HEAD_DIMS = {torch.float32: (16, 64, 128, 256),
             torch.bfloat16: (16, 64, 128, 256)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_count = _build.LaunchCount("flash_attention")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Exact attention with an f32 softmax (the reference's mha_ref).
    q: (B,H,Sq,hd); k/v: (B,KV,Sk,hd) -> (B,H,Sq,hd) in q.dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vx).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").sedar_flash_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention expects 4-D q, k, v")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads not a multiple of "
                         f"{k.shape[1]} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


def check_head_dim(what: str, dtype: torch.dtype, hd: int) -> None:
    """Raise ValueError unless the `dtype` body is built for head dim hd."""
    dims = HEAD_DIMS.get(dtype, ())
    if hd not in dims:
        raise ValueError(f"{what} ({dtype}) is built for head_dim in {dims}, "
                         f"got {hd}")


def check_aligned(what: str, **tensors) -> None:
    """Raise ValueError unless each tensor starts on a 16-byte boundary and
    its strides over dims of size > 1 (other than the last, which must be
    contiguous) are multiples of 16 bytes: the kernels' cp.async copies
    move 16 bytes at a time."""
    for name, t in tensors.items():
        unit = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
                st % unit for st, n in zip(t.stride()[:-1], t.shape[:-1])
                if n > 1):
            raise ValueError(
                f"{what} needs {name} 16-byte aligned with strides that are "
                f"multiples of {unit} elements, got offset "
                f"{t.data_ptr() % 16} bytes, strides {t.stride()}")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """K2 wrapper. q: (B,H,Sq,hd); k/v: (B,KV,Sk,hd) -> (B,H,Sq,hd)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no K2 kernel for device {q.device}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"K2 takes float32 or bfloat16, got {q.dtype}")
    check_head_dim("K2", q.dtype, hd)
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("K2 needs a contiguous head dim (stride 1)")
    if max(Sq, Sk) >= 2 ** 31:
        raise ValueError("sequence too long for K2's 32-bit positions")
    check_aligned(f"K2 ({q.dtype})", q=q, k=k, v=v)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _launcher()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), strides, B, H, KV, Sq, Sk,
                int(bool(causal)), int(window), 1.0 / math.sqrt(hd), stream)
    _build.check(rc, "flash_attention")
    launch_count.add((B, H, KV, Sq, Sk, hd, int(bool(causal)), int(window),
                      q.dtype))
    return out
