"""The paper's injection campaigns (the reference's `core/scenarios.py`).

**The replica campaign** (Sec. 4.1, Table 2). The test application is an
MPI Master/Worker matrix multiplication C = A x B with a checkpoint after
every communication:

    CK0 -> SCATTER(A) -> CK1 -> BCAST(B) -> CK2 -> MATMUL -> GATHER(C)
        -> CK3 -> VALIDATE

It runs as a deterministic phase machine in which every process is
replicated (two replicas, each owning a full copy of its memory, as torch
tensors on one device), messages are fingerprint-validated before being
sent (only replica 0's buffer is transmitted, and only when both replicas
agree: one K1 fingerprint per replica on the card, one counted host read
per validation), checkpoints snapshot the dual memory of all processes
(device clones, system-level semantics), and recovery follows Algorithm 1
with the external rollback counter.

The 64 scenarios are 8 injection windows (after each of CK0, SCATTER, CK1,
BCAST, CK2 [= during MATMUL], MATMUL, GATHER, CK3) x 2 processes (Master,
Worker 0) x 4 data (A, B, C, loop index i). For every scenario `predict`
derives (effect, P_det, P_rec, N_roll) from the liveness and transmission
schedule and the checkpoints' dirtiness, and the machine must observe
exactly that. The worker product is `torch.matmul`.

The result check: the reference compares with `np.allclose(atol=1e-4)`
against an f32 numpy product, which is sized for its n=8. Here the truth is
the f64 product of the same f32 inputs and each element of C must lie
within `1e-4 + gamma_n * (|A| @ |B|)[i, j]`, gamma_n = n u / (1 - n u),
u = 2^-24: the standard worst-case error bound of an f32 dot product of
length n in any summation order (Higham, Thm. 3.5), so it holds for every
algorithm the device's product may pick. At n=8 it accepts and rejects the
same results as the reference's check (a flipped bit 22 moves an element
far outside both).

**The ABFT campaign** corrupts a checksummed kernel's accumulated output
(injection target "kernel") and classifies what the checksums see:

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

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hostsync
from repro_torch.core.fingerprint import fingerprints_equal, leaf_fingerprints
from repro_torch.device import resolve_device

EVENTS = ["CK0", "SCATTER", "CK1", "BCAST", "CK2", "MATMUL", "GATHER",
          "CK3", "VALIDATE"]
CKPT_EVENTS = {"CK0": 0, "CK1": 2, "CK2": 4, "CK3": 7}
WINDOWS = EVENTS[:-1]          # injection happens right AFTER this event
DATA = ["A", "B", "C", "i"]
PROCESSES = ["M", "W"]
FLIP_BIT = 22                  # the paper's single bit flip (Sec. 4.2)


@dataclass(frozen=True)
class Scenario:
    sid: int
    window: str            # event after which the flip lands
    process: str           # M | W (worker 0)
    datum: str             # A | B | C | i


@dataclass
class Prediction:
    effect: str            # TDC | FSC | LE | TOE
    p_det: Optional[str]   # event at which detection fires (None for LE)
    p_rec: Optional[str]   # checkpoint that finally enables recovery
    n_roll: int


@dataclass
class Observation:
    effect: str
    p_det: Optional[str]
    p_rec: Optional[str]
    n_roll: int
    correct_result: bool


def all_scenarios() -> List[Scenario]:
    out = []
    sid = 1
    for window, proc, datum in itertools.product(WINDOWS, PROCESSES, DATA):
        out.append(Scenario(sid, window, proc, datum))
        sid += 1
    assert len(out) == 64
    return out


# ---------------------------------------------------------------------------
# Predictor (paper Sec. 4.1: every fault's consequence follows from the
# application's communication and liveness structure)
# ---------------------------------------------------------------------------

def predict(s: Scenario) -> Prediction:
    w = EVENTS.index(s.window)

    def rolls(det_event: str) -> Tuple[Optional[str], int]:
        """Checkpoints taken in (injection, detection] are dirty; Algorithm 1
        walks back through them, then one more rollback to a clean one."""
        det = EVENTS.index(det_event)
        stored = [ck for ck, e in CKPT_EVENTS.items() if e <= det]
        dirty = [ck for ck in stored if CKPT_EVENTS[ck] > w]
        clean = [ck for ck in stored if CKPT_EVENTS[ck] <= w]
        n = len(dirty) + 1
        target = clean[-1] if clean else None     # None -> restart from scratch
        return target, n

    # --- loop index ------------------------------------------------------------
    if s.datum == "i":
        if s.window == "CK2":        # during MATMUL: replica recomputes -> delay
            return Prediction("TOE", "GATHER", "CK2", 1)
        return Prediction("LE", None, None, 0)   # index dead outside MATMUL

    # --- master ------------------------------------------------------------------
    if s.process == "M":
        if s.datum == "A":
            if w < EVENTS.index("SCATTER"):
                tgt, n = rolls("SCATTER")
                return Prediction("TDC", "SCATTER", tgt, n)
            return Prediction("LE", None, None, 0)    # A(M) dead after send
        if s.datum == "B":
            if w < EVENTS.index("BCAST"):
                tgt, n = rolls("BCAST")
                return Prediction("TDC", "BCAST", tgt, n)
            return Prediction("LE", None, None, 0)
        if s.datum == "C":
            if w < EVENTS.index("GATHER"):
                return Prediction("LE", None, None, 0)  # overwritten by GATHER
            # after GATHER: local-only corruption -> final validation
            tgt, n = rolls("VALIDATE")
            return Prediction("FSC", "VALIDATE", tgt, n)

    # --- worker -------------------------------------------------------------------
    if s.datum == "A":
        # worker A block lives from SCATTER (receipt) to MATMUL (last use)
        if w < EVENTS.index("SCATTER"):
            return Prediction("LE", None, None, 0)    # overwritten at receipt
        if w < EVENTS.index("MATMUL"):
            # corrupts C(W) -> caught when C block is sent at GATHER
            tgt, n = rolls("GATHER")
            return Prediction("TDC", "GATHER", tgt, n)
        return Prediction("LE", None, None, 0)        # dead after MATMUL
    if s.datum == "B":
        if w < EVENTS.index("BCAST"):
            return Prediction("LE", None, None, 0)
        if w < EVENTS.index("MATMUL"):
            tgt, n = rolls("GATHER")
            return Prediction("TDC", "GATHER", tgt, n)
        return Prediction("LE", None, None, 0)
    # C(W): written by MATMUL, sent at GATHER, dead afterwards
    if w < EVENTS.index("MATMUL"):
        return Prediction("LE", None, None, 0)        # overwritten by MATMUL
    if w < EVENTS.index("GATHER"):
        tgt, n = rolls("GATHER")
        return Prediction("TDC", "GATHER", tgt, n)
    return Prediction("LE", None, None, 0)            # dead after GATHER


# ---------------------------------------------------------------------------
# Phase machine with the SEDAR mechanics
# ---------------------------------------------------------------------------

def _replicas_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The send validation: one fingerprint per replica (K1 on the card, the
    plain version on the CPU), one counted read of the compare."""
    return hostsync.read_bool(
        fingerprints_equal(leaf_fingerprints([a]), leaf_fingerprints([b])),
        label="campaign_validate")


def _flip(t: torch.Tensor, bit: int) -> None:
    """Flip `bit` of element min(3, size - 1) of `t` in place, on its int32
    view (the reference's u32 XOR)."""
    flat = t.view(-1).view(torch.int32)
    i = min(3, flat.numel() - 1)
    flat[i:i + 1].bitwise_xor_(1 << bit)


def _copy_mem(mem):
    return [{k: v.clone() for k, v in m.items()} for m in mem]


class MatmulTestApp:
    """Deterministic dual-replica Master/Worker matmul (paper Alg. 3), its
    memory on `device` (the card unless `device="cpu"`)."""

    def __init__(self, n: int = 8, workers: int = 2, seed: int = 0,
                 device="cuda"):
        assert n % workers == 0
        self.n = n
        self.workers = workers
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        a0 = rng.randn(n, n).astype(np.float32)
        b0 = rng.randn(n, n).astype(np.float32)
        self.A0 = torch.from_numpy(a0).to(self.device)
        self.B0 = torch.from_numpy(b0).to(self.device)
        a64, b64 = self.A0.double(), self.B0.double()
        self.truth = a64 @ b64
        u = 2.0 ** -24
        gamma = n * u / (1 - n * u)
        self.tol = 1e-4 + gamma * (a64.abs() @ b64.abs())
        self.last_mem: Optional[List[Dict[str, torch.Tensor]]] = None

    # memory layout: mem[replica]["M.A"], mem[replica][f"W{w}.A"], ...
    def _fresh_memory(self) -> List[Dict[str, torch.Tensor]]:
        n, dev = self.n, self.device
        rows = n // self.workers
        mem = []
        for _ in range(2):
            m = {"M.A": self.A0.clone(), "M.B": self.B0.clone(),
                 "M.C": torch.zeros((n, n), dtype=torch.float32, device=dev),
                 "M.i": torch.zeros((), dtype=torch.int32, device=dev)}
            for w in range(self.workers):
                m[f"W{w}.A"] = torch.zeros((rows, n), dtype=torch.float32,
                                           device=dev)
                m[f"W{w}.B"] = torch.zeros((n, n), dtype=torch.float32,
                                           device=dev)
                m[f"W{w}.C"] = torch.zeros((rows, n), dtype=torch.float32,
                                           device=dev)
                m[f"W{w}.i"] = torch.zeros((), dtype=torch.int32, device=dev)
            mem.append(m)
        return mem

    def _correct(self, c: torch.Tensor) -> bool:
        err = (c.double() - self.truth).abs() - self.tol
        return hostsync.read_bool(torch.all(err <= 0), label="campaign_check")

    def run(self, scenario: Optional[Scenario] = None) -> Observation:
        mem = self._fresh_memory()
        pc = 0
        injected = False            # the paper's injected.txt
        rollbacks = 0               # extern_counter (failures.txt)
        ckpts: List[Tuple[str, int, list]] = []   # (name, pc_after, dual mem)
        first_det: Optional[str] = None
        final_rec: Optional[str] = None
        toe_delayed = False
        effect_seen = None
        guard = 0

        def snapshot(name: str):
            ckpts.append((name, pc + 1, _copy_mem(mem)))

        def detect(event_name: str, effect: str):
            nonlocal pc, rollbacks, first_det, final_rec, mem, toe_delayed, \
                effect_seen
            if first_det is None:
                first_det = event_name
                effect_seen = effect
            rollbacks += 1
            idx = len(ckpts) - rollbacks
            toe_delayed = False
            if idx < 0:                       # relaunch from the beginning
                mem = self._fresh_memory()
                pc = 0
                final_rec = None
                return
            name, saved_pc, saved = ckpts[idx]
            mem = _copy_mem(saved)
            del ckpts[idx + 1:]               # re-stored during re-execution
            pc = saved_pc
            final_rec = name

        def validate_send(key: str, event_name: str, effect: str) -> bool:
            if not _replicas_equal(mem[0][key], mem[1][key]):
                detect(event_name, effect)
                return False
            return True

        rows = self.n // self.workers
        while pc < len(EVENTS):
            guard += 1
            if guard > 600:
                raise RuntimeError("scenario did not converge")
            ev = EVENTS[pc]

            if ev in CKPT_EVENTS:
                snapshot(ev)

            elif ev == "SCATTER":
                if not validate_send("M.A", "SCATTER", "TDC"):
                    continue
                for w in range(self.workers):
                    blk = mem[0]["M.A"][w * rows:(w + 1) * rows]
                    for r in range(2):
                        mem[r][f"W{w}.A"] = blk.clone()

            elif ev == "BCAST":
                if not validate_send("M.B", "BCAST", "TDC"):
                    continue
                for w in range(self.workers):
                    for r in range(2):
                        mem[r][f"W{w}.B"] = mem[0]["M.B"].clone()

            elif ev == "MATMUL":
                for w in range(self.workers):
                    for r in range(2):
                        mem[r][f"W{w}.C"] = torch.matmul(mem[r][f"W{w}.A"],
                                                         mem[r][f"W{w}.B"])

            elif ev == "GATHER":
                if toe_delayed:
                    detect("GATHER", "TOE")
                    continue
                failed = False
                for w in range(self.workers):
                    if not validate_send(f"W{w}.C", "GATHER", "TDC"):
                        failed = True
                        break
                if failed:
                    continue
                for w in range(self.workers):
                    blk = mem[0][f"W{w}.C"]
                    for r in range(2):
                        mem[r]["M.C"][w * rows:(w + 1) * rows].copy_(blk)

            elif ev == "VALIDATE":
                if not _replicas_equal(mem[0]["M.C"], mem[1]["M.C"]):
                    detect("VALIDATE", "FSC")
                    continue

            # -- injection: right after event `ev` ------------------------------
            if (scenario is not None and not injected
                    and ev == scenario.window):
                injected = True
                key = f"{'M' if scenario.process == 'M' else 'W0'}.{scenario.datum}"
                if scenario.datum == "i":
                    if scenario.window == "CK2":
                        toe_delayed = True      # replica 1 restarts its loop
                    # else: dead index, no memory effect
                else:
                    # single bit flip in replica 1's copy (paper Sec. 4.2)
                    _flip(mem[1][key], FLIP_BIT)

            pc += 1

        self.last_mem = mem
        ok = self._correct(mem[0]["M.C"]) and self._correct(mem[1]["M.C"])
        return Observation(
            effect=effect_seen or "LE",
            p_det=first_det,
            p_rec=final_rec,
            n_roll=rollbacks,
            correct_result=ok)


def campaign_row(s: Scenario, obs: Observation) -> dict:
    """One predicted-vs-observed row, as the reference's `run_campaign`."""
    pred = predict(s)
    return {
        "sid": s.sid, "window": s.window, "process": s.process,
        "datum": s.datum,
        "pred": dataclasses.asdict(pred),
        "obs": dataclasses.asdict(obs),
        "match": (pred.effect == obs.effect
                  and pred.p_det == obs.p_det
                  and pred.p_rec == obs.p_rec
                  and pred.n_roll == obs.n_roll
                  and obs.correct_result),
    }


def run_campaign(n: int = 8, workers: int = 2, device="cuda"):
    """Run all 64 scenarios; returns a list of dicts with predicted vs
    observed (on the card unless `device="cpu"`)."""
    app = MatmulTestApp(n=n, workers=workers, device=device)
    return [campaign_row(s, app.run(s)) for s in all_scenarios()]


# ---------------------------------------------------------------------------
# ABFT scenario classes: in-kernel corruption vs checksums
# ---------------------------------------------------------------------------

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
