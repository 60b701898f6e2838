"""Device selection and the replica-determinism settings.

Entry points run on the card unless the caller asks for the CPU; with no
card and no explicit CPU request they raise instead of quietly running on
the CPU.

Replication only detects faults if two replicas of one step give identical
bits (DESIGN.md §4), so a server built on the card turns on deterministic
algorithms, a fixed cuBLAS workspace and no TF32.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_deterministic(device: torch.device) -> None:
    """Bitwise-reproducible replicas on the card. CUBLAS_WORKSPACE_CONFIG
    only takes effect if it is set before the process's first cuBLAS call;
    a launcher that may have called cuBLAS already sets it before importing
    torch."""
    if device.type != "cuda":
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a new tensor on `device`. On the card the array is
    staged in pinned memory and copied asynchronously: a copy from pageable
    memory waits for the stream (and fails under
    `torch.cuda.set_sync_debug_mode("error")`)."""
    t = torch.from_numpy(np.array(x, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
