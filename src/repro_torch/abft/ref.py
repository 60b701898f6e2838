"""Plain PyTorch ABFT math: checksum encode / verify / correct (the
reference's `abft/ref.py`).

Algorithm-based fault tolerance for C = A @ B (Huang & Abraham; Bosilca et
al., arXiv:0806.3121): augment A with a column-checksum row and B with a
row-checksum column,

    A_c = [A ; 1^T A]   (m+1, n)        B_r = [B , B 1]   (n, k+1)

so that the one product C_f = A_c @ B_r carries the column and row sums of
its data block C = C_f[:m, :k] in its last row and column. A corrupted data
element (i, j) violates row residual i and column residual j by the same
delta, which locates it and gives the exact correction: forward repair, no
rollback and no replica. Residuals are thresholded against an eps32
roundoff bound (`residual_threshold`); a delta below it escapes ABFT, the
class the hybrid backend's fingerprint check exists for.

Everything here runs on the tensors' own device and never reads a value
back to the host: the single-element repair is an `index_add_` at an index
computed on the device, and `argmax` takes the first maximum, as
`jnp.argmax` does. `AbftReport` holds 0-d tensors; reading them is the
caller's one counted sync (`abft/executor.py`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain

EPS32 = float(np.finfo(np.float32).eps)
DEFAULT_TAU_FACTOR = 16.0


class AbftReport(NamedTuple):
    """Verification outcome of one checksummed kernel invocation (0-d
    tensors, same fields and meaning as the reference's).

    detected      -- any residual above the roundoff threshold.
    corrected     -- the violation matched the single-element pattern and
                     the output was repaired (includes hits in the checksum
                     row/column itself, where the data needs no repair).
    uncorrectable -- violations that do not localize to one element.
    bad_rows/bad_cols -- residual-violation counts (int32).
    max_residual  -- largest |residual| seen (f32).
    """

    detected: torch.Tensor
    corrected: torch.Tensor
    uncorrectable: torch.Tensor
    bad_rows: torch.Tensor
    bad_cols: torch.Tensor
    max_residual: torch.Tensor


def checksum_encode(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m,n),(n,k) -> column-checksum A_c (m+1,n) and row-checksum B_r
    (n,k+1), in f32."""
    a = a.float()
    b = b.float()
    a_c = torch.cat([a, a.sum(dim=0, keepdim=True)], dim=0)
    b_r = torch.cat([b, b.sum(dim=1, keepdim=True)], dim=1)
    return a_c, b_r


def residual_threshold(abs_sums: torch.Tensor, n_terms: int,
                       tau_factor: float = DEFAULT_TAU_FACTOR) -> torch.Tensor:
    """Roundoff bound for a checksum residual: the data-path and checksum-path
    sums each accumulate ~n_terms rounding errors of size eps*|term|. The
    factor is rounded to f32 first, as the reference's `jnp.float32(...)`."""
    factor = float(np.float32(tau_factor * EPS32 * n_terms))
    return factor * (abs_sums + 1.0)


def violated(res: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Where a checksum residual breaks its bound. A non-finite residual
    counts as violated: a bit flip that makes a NaN or an inf compares
    False against any bound, and the reference's `|res| > tau` lets it
    through (a deliberate divergence, ROADMAP F3). The NaN then fails its
    row and its column, the two deltas cannot agree, and the fault is
    uncorrectable: the caller retries or rolls back."""
    return ~(torch.isfinite(res) & (res.abs() <= tau))


def _pick(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] for a 0-d index tensor, as a device gather (no host read)."""
    return v.index_select(0, idx.reshape(1)).reshape(())


def verify_and_correct(c_full: torch.Tensor, inner_dim: int,
                       tau_factor: float = DEFAULT_TAU_FACTOR
                       ) -> Tuple[torch.Tensor, AbftReport]:
    """Check the full-checksum product and repair a single corrupted element.

    c_full: (m+1, k+1) f32 from checksum-encoded operands; inner_dim: the
    contraction length n. Returns (C data block (m, k), AbftReport). The
    decision logic is the reference's, line for line; see its comments for
    why a one-sided violation is resolved by delta agreement."""
    m, k = c_full.shape[0] - 1, c_full.shape[1] - 1
    c = c_full[:m, :k]
    row_ck = c_full[:m, k]                      # checksum column: row sums
    col_ck = c_full[m, :k]                      # checksum row: column sums

    row_res = c.sum(dim=1) - row_ck             # (m,)
    col_res = c.sum(dim=0) - col_ck             # (k,)
    n_terms = inner_dim + max(m, k)
    c_abs = c.abs()
    row_tau = residual_threshold(c_abs.sum(dim=1), n_terms, tau_factor)
    col_tau = residual_threshold(c_abs.sum(dim=0), n_terms, tau_factor)

    row_bad = violated(row_res, row_tau)
    col_bad = violated(col_res, col_tau)
    n_row = row_bad.sum().to(torch.int32)
    n_col = col_bad.sum().to(torch.int32)
    detected = (n_row + n_col) > 0

    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    i = torch.where(n_row >= 1,
                    torch.argmax(torch.where(row_bad, row_res.abs(), zero)),
                    torch.argmax(row_res.abs()))
    j = torch.where(n_col >= 1,
                    torch.argmax(torch.where(col_bad, col_res.abs(), zero)),
                    torch.argmax(col_res.abs()))
    row_i, col_j = _pick(row_res, i), _pick(col_res, j)
    deltas_agree = (row_i - col_j).abs() <= (_pick(row_tau, i)
                                             + _pick(col_tau, j))
    single_pattern = detected & (n_row <= 1) & (n_col <= 1)
    data_fix = single_pattern & deltas_agree
    ck_hit = single_pattern & ~deltas_agree & ((n_row == 1) ^ (n_col == 1))

    corrected = detected & (data_fix | ck_hit)
    uncorrectable = detected & ~corrected

    # c.at[i, j].add(-fix_delta) under data_fix: adding -0.0 leaves every
    # value bit for bit as it was (also -0.0, inf and NaN)
    fix_delta = torch.where(n_row >= 1, row_i, col_j)
    step = torch.where(data_fix, -fix_delta, torch.full_like(fix_delta, -0.0))
    out = c.clone(memory_format=torch.contiguous_format)
    out.view(-1).index_add_(0, (i * k + j).reshape(1), step.reshape(1))
    report = AbftReport(
        detected=detected, corrected=corrected, uncorrectable=uncorrectable,
        bad_rows=n_row, bad_cols=n_col,
        max_residual=torch.maximum(row_res.abs().max(),
                                   col_res.abs().max()).float())
    return out, report


def abft_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                    inject: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]] = None,
                    tau_factor: float = DEFAULT_TAU_FACTOR
                    ) -> Tuple[torch.Tensor, AbftReport]:
    """Checksummed matmul oracle: encode -> plain f32 product -> verify.
    `inject` (`injection.make_kernel_fault`) corrupts the full-checksum
    product between compute and verify — the in-kernel SDC model."""
    a_c, b_r = checksum_encode(a, b)
    c_full = torch.matmul(a_c, b_r)
    if inject is not None:
        c_full = inject(c_full)
    return verify_and_correct(c_full, a.shape[1], tau_factor)


# ---------------------------------------------------------------------------
# Checksummed attention invariant (the PV-matmul protection)
# ---------------------------------------------------------------------------

def attention_checksum_encode(v: torch.Tensor) -> torch.Tensor:
    """Append a checksum lane sum_d v[..., d] to V's head dim. Attention is
    linear in V, so the output's extra lane equals the sum of its data
    lanes per (batch, head, query) row, whatever the weights are; a
    corruption of the QK^T logits moves every lane consistently and
    escapes."""
    return torch.cat([v, v.sum(dim=-1, keepdim=True)], dim=-1)


def attention_verify(out_full: torch.Tensor, seq_k: int,
                     tau_factor: float = DEFAULT_TAU_FACTOR
                     ) -> Tuple[torch.Tensor, AbftReport]:
    """Check the output checksum lane; returns (out data, report).
    Detection only: a row residual flags the query row, not the lane, so a
    violation is uncorrectable."""
    out = out_full[..., :-1]
    res = out.sum(dim=-1) - out_full[..., -1]
    hd = out.shape[-1]
    tau = residual_threshold(out.abs().sum(dim=-1), hd + seq_k, tau_factor)
    n_bad = violated(res, tau).sum().to(torch.int32)
    detected = n_bad > 0
    report = AbftReport(
        detected=detected,
        corrected=torch.zeros((), dtype=torch.bool, device=out.device),
        uncorrectable=detected, bad_rows=n_bad,
        bad_cols=torch.zeros((), dtype=torch.int32, device=out.device),
        max_residual=res.abs().max().float())
    return out, report


def abft_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                       inject: Optional[Callable] = None,
                       tau_factor: float = DEFAULT_TAU_FACTOR
                       ) -> Tuple[torch.Tensor, AbftReport]:
    """Checksummed exact attention (oracle for `abft_flash_attention`)."""
    v_aug = attention_checksum_encode(v.float())
    out_full = flash_attention_plain(q.float(), k.float(), v_aug,
                                     causal=causal, window=window)
    if inject is not None:
        out_full = inject(out_full)
    return attention_verify(out_full, k.shape[2], tau_factor)
