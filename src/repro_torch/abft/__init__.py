"""ABFT subsystem: checksum-carrying kernels + the replica-free executor
(the reference's `abft/`).

Row/column checksums carried through the computation detect — and for a
single corrupted element, correct — soft errors at the cost of one
verification pass instead of duplicated execution. `matmul_kernel` is the
counterpart of the reference's `matmul_pallas` (kernel K3).
"""
from repro_torch.abft.executor import AbftExecutor
from repro_torch.abft.kernels import (abft_flash_attention, abft_matmul,
                                      matmul_kernel)
from repro_torch.abft.ref import (AbftReport, abft_attention_ref,
                                  abft_matmul_ref, attention_checksum_encode,
                                  attention_verify, checksum_encode,
                                  residual_threshold, verify_and_correct)

__all__ = [
    "AbftExecutor", "AbftReport", "abft_attention_ref", "abft_flash_attention",
    "abft_matmul", "abft_matmul_ref", "attention_checksum_encode",
    "attention_verify", "checksum_encode", "matmul_kernel",
    "residual_threshold", "verify_and_correct",
]
