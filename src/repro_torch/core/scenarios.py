"""The ABFT scenario campaign (the ABFT part of the reference's
`core/scenarios.py`; the replica campaign comes with the training slice).

The campaign corrupts a checksummed kernel's accumulated output (injection
target "kernel") and classifies what the checksums see:

  corrected     -- single element, delta above the roundoff floor: the
                   row+column residual pair localizes it; forward repair.
  uncorrectable -- multiple elements: residual violations do not localize;
                   the output is untrusted and recovery must act.
  escaped_fsc   -- delta below the residual noise floor (low-order mantissa
                   bit): numerically harmless, invisible to ABFT — the
                   class the hybrid backend's FSC fingerprint boundary (or
                   replication) exists for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

ABFT_CLASSES = ("corrected", "uncorrectable", "escaped_fsc")


@dataclass(frozen=True)
class AbftScenario:
    sid: int
    bit: int              # flipped bit of the f32 pattern
    n_elems: int          # corrupted output elements
    predicted: str        # one of ABFT_CLASSES


def abft_scenarios() -> List[AbftScenario]:
    """12 scenarios x 3 classes: high-mantissa single flips (corrected),
    multi-element flips (uncorrectable), low-order mantissa flips (escaped).
    The flip lands on the largest-magnitude output element (plus diagonal
    neighbours), so the class follows from (bit, n_elems) alone."""
    out, sid = [], 1
    for bit in (21, 22, 23, 21):
        out.append(AbftScenario(sid, bit, 1, "corrected"))
        sid += 1
    for bit, n_elems in ((21, 2), (22, 3), (23, 4), (21, 3)):
        out.append(AbftScenario(sid, bit, n_elems, "uncorrectable"))
        sid += 1
    for bit in (0, 1, 2, 3):
        out.append(AbftScenario(sid, bit, 1, "escaped_fsc"))
        sid += 1
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def classify_abft(report, c, clean) -> str:
    """Observed class from a kernel report + output vs the clean product."""
    if bool(_host(report.uncorrectable)):
        return "uncorrectable"
    if bool(_host(report.corrected)):
        return "corrected"
    if not np.array_equal(_host(c), _host(clean)):
        return "escaped_fsc"
    return "clean"


def run_abft_campaign(m: int = 24, n: int = 16, k: int = 20, seed: int = 0,
                      matmul: Optional[Callable] = None, device="cpu"):
    """Run every ABFT scenario through a checksummed matmul — by default the
    plain reference lowering `abft_matmul_ref`, as the reference does; pass
    `matmul=abft.kernels.abft_matmul` and a CUDA device to replay the same
    campaign through kernel K3. Returns predicted-vs-observed rows."""
    from repro_torch.abft.ref import abft_matmul_ref
    from repro_torch.core.injection import InjectionSpec, make_kernel_fault

    matmul = matmul or abft_matmul_ref
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.randn(n, k).astype(np.float32)).to(device)
    clean, _ = matmul(a, b)
    # anchor every flip at the largest data element whose diagonal spread
    # stays INSIDE the data block (not the checksum row/column, no wrap)
    spread = max(s.n_elems for s in abft_scenarios()) - 1
    if not (m > spread and k > spread):
        raise ValueError(f"campaign shape {m}x{k} too small for a diagonal "
                         f"spread of {spread}")
    interior = np.abs(_host(clean))[:m - spread, :k - spread]
    i0, j0 = np.unravel_index(int(np.argmax(interior)), interior.shape)
    target = int(i0) * (k + 1) + int(j0)                   # data -> full idx
    rows = []
    for s in abft_scenarios():
        spec = InjectionSpec(leaf_idx=0, flat_idx=target, bit=s.bit,
                             step=0, target="kernel", n_elems=s.n_elems,
                             dtype="float32")
        c, report = matmul(a, b, inject=make_kernel_fault(spec, step=0,
                                                          armed=True))
        obs = classify_abft(report, c, clean)
        correct = bool(np.allclose(_host(c), _host(clean), atol=1e-3))
        rows.append({
            "sid": s.sid, "bit": s.bit, "n_elems": s.n_elems,
            "pred": s.predicted, "obs": obs,
            # corrected/clean outputs must match the clean product; an
            # uncorrectable output is untrusted (no claim either way)
            "match": (obs == s.predicted
                      and (correct if obs != "uncorrectable" else True)),
        })
    return rows
