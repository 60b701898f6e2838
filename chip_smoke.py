"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc` (one nvcc per
source, in parallel; ptxas's registers and spills are printed per kernel)
and holds each kernel against its plain PyTorch version on the card (K1
also on leaves read in place, with its device launches per call counted by
torch.profiler). Then it drives the port's paths, each with the kernels' launch
counts set to 0 just before it and read just after:

  * the main path — protected dual-replica `SedarServer.generate` of
    qwen2-0.5b at full width with seeded random weights, prefill attention
    through the flash kernel K2, commit compares through K1 (the bf16
    logits read in place): a clean run
    has no detection and emits the unprotected run's tokens, an injected
    bit flip is detected and retried without changing the tokens; the same
    under the single-launch `fused` backend (both replicas as 2B rows);
  * the ABFT slice — the checksummed matmul K3 through `abft_matmul`
    (the 12-scenario campaign, and `SedarEngine` + `AbftExecutor` with a
    forward correction and a retry), the checksummed flash attention K4
    through `abft_flash_attention` at the model's prefill shapes, and the
    replica-free `abft`/`hybrid` serving of the same model (clean runs equal
    the unprotected tokens; a kernel fault is corrected forward), with K1
    in place on the hybrid backend's fingerprint tree of a real state and
    a profile (launches per decode step) of dual, abft and hybrid;
  * continuous-batching `SedarServer.serve` of the same model (8 requests
    in 4 slots, under sync-debug "error"): unprotected, dual and fused at
    lag 1 and lag 8, abft and hybrid, slot, kernel-domain and admission
    fault campaigns, K1 (also its row-limit leaves, hybrid's resident
    baseline) and K2 (also at the fused pack's 2K rows) held against their
    plain versions at the shapes this path gives them, and the backends'
    ms/step in turns;
  * the paper's 64-scenario replica campaign (Table 2) with its memory on
    the card, at n=8 and n=4096, each send checked by two K1 launches;
  * protected training (phase train): qwen2-0.5b at full width and depth
    under L3 with the sequential backend — a clean run, a grads fault
    restored from the validated checkpoint and bitwise equal to the clean
    run, a profiled protected step, seconds and bytes per checkpoint, K1
    on the full grads and params+m+v trees against its plain version —
    then the fused, abft and hybrid backends under L3 (clean runs, the
    fused grads fault, hybrid's catch of an at-rest fault that pure abft
    misses), the device/host/disk tiers (a restore from the device ring
    with no disk or host read), ms/step of all five backends in turns,
    and L1/L2 plus the tiers and the partner fallback on paper-testapp;
  * the telemetry loop (phase telemetry): the serve phase's server with
    metrics, journal, trace and a serve-mode autotuner on reads, launches
    and streams exactly what it does with them off; a journaled lag-8 slot
    fault that `obs.reconcile` reproduces; a trace with the serving spans;
    the serve launcher with --metrics-dir --trace --autotune and the
    status page as subprocesses; full-width L3 training at lag 8 with a
    train-mode autotuner whose reconfigs land at clean boundaries, losses
    bitwise equal to the run with telemetry off; the calibrated temporal
    model and `advise()` on it;
  * a small f32 model on the card against the plain CPU path.

Any failed check exits non-zero. The last two lines are a JSON object of
kernel numbers and the result line.

Numbers: a kernel's time (`ms` in the kernels line), its plain version's
and the library call's are device times: each kernel a call launches, at
its mean duration over many warm calls as torch.profiler records them,
times its launches per call (deterministic mode's fills of fresh outputs
left out). Beside them the K1–K4 lines
print the time per call between CUDA events, which includes the host's
time between launches and sets the number for a kernel of a few
microseconds. The bound is max(bytes / 3.35 TB/s, operations / peak),
the H100 SXM's published rates — 989 TFLOP/s for bf16 on the tensor
cores, 67 TFLOP/s for f32 outside them (K3 and K4 compute in true f32) —
with bytes counting each input read once and each output written once.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# a full-width fused training step peaks near 70 of the card's 79 GiB; the
# caching allocator's split blocks then left 6-9 GiB reserved but unusable
# and the step ran out of memory: expandable segments grow in place
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
PROMPT_LEN = 256
BATCH = 4
STEPS = 32
ENGINE_M = BATCH * PROMPT_LEN    # engine state x (ENGINE_M, ENGINE_N)
ENGINE_N = 896
ENGINE_STEPS = 8
ENGINE_FAULT_STEP = 4
FAULT_BIT = 26    # exponent bit 3: x256 for 2 <= |v| < 256
TRAIN_SEQ = 256
TRAIN_STEPS = 6
TRAIN_BACKENDS = ("none", "sequential", "fused", "abft", "hybrid")
PROFILE_TRIES = 3   # profiles of one measurement that may keep no record


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of fn(): the kernels it launches, from
    torch.profiler, without deterministic mode's fills of fresh outputs.
    Unlike cuda_ms it leaves out the host's time between launches, which
    sets cuda_ms for a kernel of a few microseconds. Each kernel counts at
    its mean recorded duration times its launches per call (its records
    over `iters`, rounded): the profiler's device records of this torch
    build can miss a launch now and then, which a plain sum would read as
    less device time. They can also miss every record of a window of
    calls (seen for K1 in the serve phase, 0 of 200): then the profile is
    taken again, and after PROFILE_TRIES empty profiles the call is timed
    by CUDA events (cuda_ms, the host's gaps included), which is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_call = 0.0
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA or not e.count
                    or "fill" in e.key.lower()):
                continue
            launches = max(1, round(e.count / iters))
            if e.count != launches * iters:
                print(f"  (profiler recorded {e.count} of {launches * iters}"
                      f" launches of {e.key[:60]})", flush=True)
            per_call += e.self_device_time_total / e.count * launches
        if per_call > 0:
            return per_call / 1e3
        print(f"  (profile {attempt} of {PROFILE_TRIES} kept no device "
              f"record of {iters} calls)", flush=True)
    ms = cuda_ms(fn, iters, warmup=0)
    print(f"  (device time by CUDA events instead: {ms:.4f} ms per call, "
          f"the host's gaps between launches included)", flush=True)
    return ms


def _demangle(sym: str) -> str:
    """function<template args> of a kernel in an unnamed namespace."""
    import re
    m = re.match(r"_ZN(\d+)", sym)
    if not m:
        return sym
    rest = sym[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    name = rest[m.end():m.end() + int(m.group(1))]
    rest = rest[m.end() + int(m.group(1)):]
    if rest.startswith("I"):
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E",
                                          rest[:rest.index("EE") + 1])) + ">"
    return name


def ptxas_report(logs) -> dict:
    """{kernel: (registers, spill bytes, static shared memory bytes)} from
    the `nvcc -Xptxas -v` logs of a build; a kernel is named by its
    function and template arguments, e.g. flash_fwd_f32<64,1>."""
    import re
    out, fn, spill = {}, None, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:   # _ZN <namespace> <function> [I <template args> E] E ...
                fn, spill = _demangle(m.group(1)), None
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                sm = re.search(r"(\d+) bytes smem", line)
                out[fn] = (int(m.group(1)), spill,
                           int(sm.group(1)) if sm else 0)
    return out


def bound(bytes_: float, ops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_launches(fn, iters: int = 20):
    """Launches per call of fn() over `iters` warm calls, by torch.profiler:
    (kernel launch calls the host made, kernels the device ran, the
    kernels' names). The host's launch calls are the count: the profiler's
    device records of this torch build can miss a kernel now and then (in
    one run 12 of 20 one-launch calls showed a kernel, in another 19), and
    a profile that kept no device record at all is taken again, up to
    PROFILE_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        kern = [e for e in evs if e.device_type == DeviceType.CUDA]
        if kern:
            break
        print(f"  (profile {attempt} of {PROFILE_TRIES} kept no device "
              f"record of {iters} calls)", flush=True)
    return (_launch_calls(evs) / iters, sum(e.count for e in kern) / iters,
            sorted({e.key for e in kern}))


def _k1_words(fp) -> np.ndarray:
    return fp.cpu().numpy().view(np.uint32)


def k1_tree_values(kfp, tree, what: str):
    """K1 in place (`pytree_fingerprint_fused`) against pack + plain and the
    plain leaf walk: hash words and absmax bitwise, the sum within 1e-5 of
    sum |x|, one wrapper launch per call. Returns (|ds|, table rows, words)."""
    from repro_torch.core.fingerprint import (pack_tree_u32,
                                              pytree_fingerprint_fused)
    from repro_torch.tree import leaves
    table = kfp.leaf_table(leaves(tree))
    check(bool(table), f"K1: no in-place table for {what}")
    before = kfp.launch_count.n
    got = _k1_words(pytree_fingerprint_fused(tree))
    check(kfp.launch_count.n == before + 1, f"K1 wrapper calls off ({what})")
    packed = pack_tree_u32(tree)
    want = _k1_words(kfp.fingerprint_plain(packed))
    walk = _k1_words(kfp.fingerprint_leaves_plain(table))
    for ref, name in ((want, "pack + plain"), (walk, "the plain leaf walk")):
        check(np.array_equal(got[[0, 1, 3]], ref[[0, 1, 3]]),
              f"K1 in place differs from {name} on {what}: {got} vs {ref}")
    ds = abs(float(got[2:3].view(np.float32)[0])
             - float(want[2:3].view(np.float32)[0]))
    scale = max(float(packed.view(torch.float32).abs().sum()), 1.0)
    check(ds <= 1e-5 * scale, f"K1 sum off on {what}: {ds}")
    return ds, len(table), packed.numel()


def check_k1_tree(kfp, tree, what: str) -> float:
    """`k1_tree_values`, and one device launch per call by torch.profiler
    (one host launch call, its kernel's record seen). Returns |ds|."""
    from repro_torch.core.fingerprint import pytree_fingerprint_fused
    ds, rows, words = k1_tree_values(kfp, tree, what)
    calls, ran, names = device_launches(lambda: pytree_fingerprint_fused(tree))
    check(calls == 1 and ran <= 1 and len(names) == 1,
          f"K1 in place: {calls} launch calls and {ran} device kernels per "
          f"call on {what}: {names}")
    print(f"K1 in place on {what} ({rows} table rows, "
          f"{words} words): h1/h2/absmax bitwise equal to pack + "
          f"plain and to the plain leaf walk, |ds|={ds:.3e}, "
          f"{calls:g} launch call and {ran:g} device kernel per call "
          f"({names[0]})", flush=True)
    return ds


def phase_k1(kfp):
    """K1 against its plain version on packed buffers (hash words and absmax
    bitwise, the sum close) and one device launch per call; then the main
    path's call, the bf16 logits read in place. Returns the kernels-line
    entry for that call; its max_abs_err is the largest |kernel - plain|
    over the four result words (the hash words and absmax are checked
    equal, so it is the sum word's error)."""
    from repro_torch.core.fingerprint import pack_tree_u32
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    sizes = [0, 1, 127, 128 * 256 + 1, BATCH * 151_936, 100_000_000]
    max_err = 0.0
    for n in sizes:
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn(n, generator=gen, device=dev) * 3
        u = x.view(torch.int32)
        got = _k1_words(kfp.fingerprint_u32(u))
        again = _k1_words(kfp.fingerprint_u32(u))
        want = _k1_words(kfp.fingerprint_plain(u))
        check(np.array_equal(got[:2], want[:2]),
              f"K1 hash words differ from plain at n={n}: {got} vs {want}")
        check(got[3] == want[3], f"K1 absmax differs at n={n}")
        check(np.array_equal(got, again),
              f"K1 not bitwise repeatable at n={n}")
        gs, ga = (float(v) for v in got[2:].view(np.float32))
        ws, wa = (float(v) for v in want[2:].view(np.float32))
        dh = int(np.abs(got[:2].astype(np.int64) - want[:2].astype(np.int64))
                 .max())
        err = max(float(dh), abs(gs - ws), abs(ga - wa))
        max_err = max(max_err, err)
        scale = max(float(x.abs().sum()), 1.0)
        check(abs(gs - ws) <= 1e-5 * scale, f"K1 sum off at n={n}: {gs} {ws}")
        print(f"K1 n={n}: h1/h2/absmax bitwise equal to plain, two calls "
              f"bitwise equal, sum |ds|={abs(gs - ws):.3e} "
              f"(|ds|/sum|x|={abs(gs - ws) / scale:.3e})", flush=True)
    n = BATCH * 151_936
    u = (torch.randn(n, device=dev) * 3).view(torch.int32)
    calls, ran, names = device_launches(lambda: kfp.fingerprint_u32(u))
    check(calls == 1 and ran <= 1 and len(names) == 1,
          f"K1: {calls} launch calls and {ran} device kernels per call "
          f"({names})")
    packed_ms = device_ms(lambda: kfp.fingerprint_u32(u), 200)
    packed_call_ms = cuda_ms(lambda: kfp.fingerprint_u32(u), 200)
    big = (torch.randn(100_000_000, device=dev)).view(torch.int32)
    big_ms = device_ms(lambda: kfp.fingerprint_u32(big), 20)
    print(f"K1 at n={n} f32 words (a packed buffer): device "
          f"{packed_ms:.4f} ms "
          f"(per call {packed_call_ms:.4f} ms), {calls:g} launch call and "
          f"{ran:g} device kernel per call; at n=1e8: {big_ms:.4f} ms = "
          f"{4e8 / big_ms / 1e9:.3f} TB/s",
          flush=True)

    # the main path's call: the dual backend's bf16 logits, read in place
    logits = (torch.randn(BATCH, 151_936, device=dev) * 3).bfloat16()
    tree = {"logits": logits}
    max_err = max(max_err, check_k1_tree(kfp, tree, "bf16 logits (4, 151936)"))
    table = kfp.leaf_table([logits])
    ms = device_ms(lambda: kfp.fingerprint_leaves(table), 200)
    call_ms = cuda_ms(lambda: kfp.fingerprint_leaves(table), 200)
    plain_ms = device_ms(lambda: kfp.fingerprint_leaves_plain(table), 20)
    route_ms = device_ms(lambda: ops.fingerprint_packed(pack_tree_u32(tree)),
                         200)
    b_ms, b_by = bound(2 * n + 16, 0)
    print(f"K1 in place on the bf16 logits: device {ms:.4f} ms (per call "
          f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, the packed route "
          f"(cast + K1) {route_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"max |kernel - plain| over the result words {max_err:.3e}",
          flush=True)
    return {"name": "fingerprint", "route": "cuda",
            "source": "src/repro_torch/csrc/fingerprint.cu",
            "replaces": "src/repro/kernels/fingerprint.py:51",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_k1_tree(kfp, main):
    """K1 in place on the hybrid backend's fingerprint tree of a real
    full-width server state (the KV cache rows [0, pos) of both caches and
    the token, after prefill and 8 decode steps), against pack + plain."""
    from repro_torch.configs import RunConfig
    from repro_torch.core.fingerprint import (pack_tree_u32,
                                              pytree_fingerprint_fused)
    from repro_torch.core.policy import make_server
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    cfg, params, prompt = main["cfg"], main["params"], main["prompt"]
    srv = make_server(RunConfig(model=cfg), backend="hybrid", device=dev)
    logits, cache = srv.model.prefill(params, {"tokens": prompt},
                                      PROMPT_LEN + STEPS + 8)
    tok, pos = torch.argmax(logits, dim=-1), PROMPT_LEN
    for _ in range(8):
        logits, cache = srv.model.decode_step(params, cache, tok, pos)
        tok, pos = torch.argmax(logits, dim=-1), pos + 1
    tree = srv._fp_tree({"cache": cache, "tok": tok, "pos": pos})
    check_k1_tree(kfp, tree, f"the hybrid tree at pos {pos}")
    ms = device_ms(lambda: pytree_fingerprint_fused(tree), 50)
    route_ms = device_ms(lambda: ops.fingerprint_packed(pack_tree_u32(tree)),
                         50)
    route_calls, _, _ = device_launches(
        lambda: ops.fingerprint_packed(pack_tree_u32(tree)))
    nbytes = sum(c.numel() * c.element_size()
                 for c in tree["cache"].values()) + 8 * tok.numel() + 16
    b_ms, b_by = bound(nbytes, 0)
    print(f"K1 in place on the hybrid tree: device {ms:.4f} ms, the packed "
          f"route (cast, copy, cat + K1) {route_ms:.4f} ms in "
          f"{route_calls:g} launch calls, bound {b_ms:.5f} ms ({b_by})",
          flush=True)


def check_k2(kfa, B: int, S: int, seed: int, what: str):
    """K2 against its plain version in bf16 on seeded (B, S) inputs at
    qwen2-0.5b's heads, in the model's layout: elementwise within atol 1e-3
    + rtol 8e-3 (one bf16 rounding step is at most 2^-7 of the value), each
    row within 1e-2 of its largest output, and two launches bitwise equal.
    Returns (q, k, v, max abs err, max error per row's largest value)."""
    dev = torch.device("cuda")
    H, KV, hd = 14, 2, 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    # model layout (B, S, heads, hd), viewed as (B, heads, S, hd) as the
    # model's prefill passes it
    q = torch.randn(B, S, H, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    got = kfa.flash_attention_fwd(q, k, v, causal=True)
    again = kfa.flash_attention_fwd(q, k, v, causal=True)
    want = kfa.flash_attention_plain(q, k, v, causal=True)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    over = float((diff - (1e-3 + 8e-3 * want.float().abs())).max())
    # each row's error against that row's largest output: a late row
    # averages many keys and is small, so an absolute bound alone would
    # let a dropped or misweighted KV tile there pass; one bf16 rounding
    # step of a row's largest value is at most 2^-7 of it
    row_err = float((diff.amax(-1) / want.float().abs().amax(-1)
                     .clamp_min(1e-6)).max())
    check(bool(torch.isfinite(got).all()), f"K2 non-finite at {what}")
    check(over <= 0, f"K2 off plain beyond atol 1e-3 + rtol 8e-3 at "
          f"{what} (max abs err {err})")
    check(row_err <= 1e-2,
          f"K2 max error per row's largest value {row_err} > 1e-2 at {what}")
    check(torch.equal(got, again), f"K2 not bitwise repeatable at {what}")
    return q, k, v, err, row_err


def phase_k2(kfa):
    """K2 against its plain version (`check_k2`) at qwen2-0.5b prefill
    shapes, timed beside its plain version and SDPA."""
    import torch.nn.functional as F
    H, KV, hd = 14, 2, 64
    entry = None
    for S in (PROMPT_LEN, 2048):
        q, k, v, err, row_err = check_k2(kfa, BATCH, S, S, f"S={S}")

        def kernel():
            kfa.flash_attention_fwd(q, k, v, causal=True)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)

        ms, call_ms = device_ms(kernel, 50), cuda_ms(kernel, 50)
        lib_ms, lib_call_ms = device_ms(sdpa, 50), cuda_ms(sdpa, 50)
        plain_ms = device_ms(
            lambda: kfa.flash_attention_plain(q, k, v, causal=True), 10)
        pairs = S * (S + 1) // 2                 # unmasked (q, k) pairs
        flops = 4.0 * BATCH * H * hd * pairs     # QK^T and PV
        nbytes = 2.0 * BATCH * S * hd * (2 * H + 2 * KV)
        b_ms, b_by = bound(nbytes, flops)
        print(f"K2 S={S}: max abs err {err:.3e}, per row's largest value "
              f"{row_err:.3e} vs plain (bf16), two launches bitwise equal, "
              f"device {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms; per call (host included) {call_ms:.4f} ms, "
              f"sdpa {lib_call_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s "
              f"on the function's count, {1.5 * flops / ms / 1e9:.1f} "
              f"executed (P.V twice: hi + lo)", flush=True)
        if S == PROMPT_LEN:
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:33",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


def decode_ms(rep) -> float:
    """Host wall time per decode step of a generate (prefill excluded)."""
    return (rep.wall_s - rep.prefill_s) / (STEPS - 1) * 1e3


def phase_main(kfp, kfa, cfg_full):
    """The main path at full width: clean dual run, unprotected run, fault
    run, then a profile. Returns the launch counts of the clean run and
    what the replica-free serving phase compares with."""
    import dataclasses

    from repro_torch.configs import RunConfig
    from repro_torch.core import hostsync
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    cfg = dataclasses.replace(cfg_full, attention_impl="pallas")
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN))).to(dev)
    srv = make_server(RunConfig(model=cfg), dual=True, device=dev)
    t0 = time.time()
    params = srv.model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    print(f"main path: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} V={cfg.vocab_size}, "
          f"{n_params / 1e6:.1f}M f32 params (seeded init "
          f"{time.time() - t0:.2f} s), bf16 compute, B={BATCH} "
          f"prompt={PROMPT_LEN} steps={STEPS}", flush=True)
    srv.generate(params, {"tokens": prompt}, steps=2)        # warm-up
    torch.cuda.synchronize()

    kfp.launch_count.reset()
    kfa.launch_count.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")   # a read outside hostsync fails
    try:
        with hostsync.count_transfers() as st:
            toks, rep = srv.generate(params, {"tokens": prompt}, steps=STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = {"fingerprint": kfp.launch_count.n,
              "flash_attention": kfa.launch_count.n}
    print(f"main path launches: {counts}; host reads {st.by_label}",
          flush=True)
    check(toks.shape == (BATCH, STEPS), f"token shape {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token ids out of range")
    check(not rep.detections and not rep.stopped,
          f"clean run detected {[str(e) for e in rep.detections]}")
    check(counts["fingerprint"] >= 2 * (STEPS - 1),
          f"K1 launched {counts['fingerprint']} < {2 * (STEPS - 1)} times")
    check(counts["flash_attention"] == cfg.num_layers,
          f"K2 launched {counts['flash_attention']} != {cfg.num_layers}")
    check(st.by_label == {"commit_compare": STEPS - 1, "token_emit": STEPS},
          f"host reads {st.by_label}")
    name = torch.cuda.get_device_name(0)
    print(f"main path on {name}: {rep.tokens_emitted / rep.wall_s:.1f} "
          f"tokens/s ({rep.tokens_emitted} tokens in {rep.wall_s:.3f} s), "
          f"prefill+first token {rep.prefill_s * 1e3:.2f} ms, decode "
          f"{decode_ms(rep):.2f} ms/step (both replicas + compare), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    plain_srv = make_server(RunConfig(model=cfg), dual=False, device=dev)
    ptoks, prep = plain_srv.generate(params, {"tokens": prompt}, steps=STEPS)
    check(np.array_equal(ptoks, toks),
          "dual-replica tokens differ from the unprotected run")
    print(f"unprotected run: same tokens, {prep.tokens_emitted / prep.wall_s:.1f}"
          f" tokens/s, decode {decode_ms(prep):.2f} ms/step", flush=True)

    spec = InjectionSpec(leaf_idx=1, flat_idx=3, bit=30,
                         step=PROMPT_LEN + 5, replica=1, target="params")
    fsrv = make_server(RunConfig(model=cfg), dual=True, device=dev,
                       inj_spec=spec)
    ftoks, frep = fsrv.generate(params, {"tokens": prompt}, steps=STEPS)
    events = [(e.step, e.boundary, e.effect) for e in frep.detections]
    print(f"fault run: detections {events}, retries {frep.retries}, "
          f"stopped {frep.stopped}", flush=True)
    check(len(frep.detections) >= 1 and frep.retries >= 1,
          "injected fault not detected and retried")
    check(not frep.stopped, "fault run stopped")
    check(np.array_equal(ftoks, toks), "fault run changed the tokens")

    phase_fused_generate(kfp, kfa, cfg, params, prompt, toks, spec)

    logits, _ = srv.model.prefill(params, {"tokens": prompt}, PROMPT_LEN + 8)
    check(tuple(logits.shape) == (BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits shape {tuple(logits.shape)} or not finite")
    run = {"cfg": cfg, "params": params, "prompt": prompt, "tokens": toks}
    phase_k1_tree(kfp, run)
    phase_profile(srv, params, prompt, "a dual")
    return counts, run


def phase_fused_generate(kfp, kfa, cfg, params, prompt, dual_toks, spec):
    """The fused backend through `generate()`: both replicas' B rows in one
    decode. A clean run under sync-debug "error" (tokens equal dual's; K1
    twice per decode step and K2 once per layer, counted; exact host
    reads),
    then the dual fault run's `final_ln` fault: detected, retried, clean
    tokens."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import hostsync
    from repro_torch.core.policy import make_server
    dev = torch.device("cuda")
    srv = make_server(RunConfig(model=cfg), backend="fused", device=dev)
    srv.generate(params, {"tokens": prompt}, steps=2)        # warm-up
    torch.cuda.synchronize()
    kfp.launch_count.reset()
    kfa.launch_count.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with hostsync.count_transfers() as st:
            toks, rep = srv.generate(params, {"tokens": prompt}, steps=STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = {"fingerprint": kfp.launch_count.n,
              "flash_attention": kfa.launch_count.n}
    print(f"fused generate: launches {counts}; host reads {st.by_label}; "
          f"decode {decode_ms(rep):.2f} ms/step (both replicas in one "
          f"launch + compare), {rep.tokens_emitted / rep.wall_s:.1f} "
          f"tokens/s", flush=True)
    check(np.array_equal(toks, dual_toks), "fused tokens differ from dual's")
    check(not rep.detections and not rep.stopped,
          f"clean fused run detected {[str(e) for e in rep.detections]}")
    check(counts == {"fingerprint": 2 * (STEPS - 1),
                     "flash_attention": cfg.num_layers},
          f"fused launches {counts}")
    check(st.by_label == {"commit_compare": STEPS - 1, "token_emit": STEPS},
          f"fused host reads {st.by_label}")

    # why the fused decode runs its attention per replica half: one decode
    # of the stacked 2B rows against a replica decoded alone, with the
    # attention over all 2B rows (row_blocks=1) and per half (2), at the
    # cache length of the generate above (cuBLAS picks the batched
    # products' algorithm by their shape: batch count and cache length)
    logits, cache = srv.model.prefill(params, {"tokens": prompt},
                                      PROMPT_LEN + STEPS + 8)
    tok = torch.argmax(logits, dim=-1)
    alone, _ = srv.model.decode_step(
        params, {n: c.clone() for n, c in cache.items()}, tok, PROMPT_LEN)
    same = {}
    for blocks in (1, 2):
        stacked = {n: torch.cat([c, c.clone()], dim=1)
                   for n, c in cache.items()}
        out, _ = srv.model.decode_step(params, stacked, torch.cat([tok, tok]),
                                       PROMPT_LEN, row_blocks=blocks)
        same[blocks] = (torch.equal(out[:BATCH], alone),
                        float((out[:BATCH].float() - alone.float()).abs()
                              .max()))
    print(f"stacked decode of 2B={2 * BATCH} rows against one replica's "
          f"B={BATCH}: attention over all rows bitwise equal {same[1][0]} "
          f"(max |diff| {same[1][1]:.3e}); attention per half bitwise equal "
          f"{same[2][0]}", flush=True)
    check(same[2][0], "fused decode (attention per half) differs from a "
          "replica decoded alone")

    fsrv = make_server(RunConfig(model=cfg), backend="fused", device=dev,
                       inj_spec=spec)
    ftoks, frep = fsrv.generate(params, {"tokens": prompt}, steps=STEPS)
    events = [(e.step, e.boundary, e.effect) for e in frep.detections]
    print(f"fused fault run (final_ln[3] bit 30, replica 1): detections "
          f"{events}, retries {frep.retries}, stopped {frep.stopped}",
          flush=True)
    check(events == [(spec.step, "commit", "TDC")] and frep.retries == 1
          and not frep.stopped, "fused: fault not detected and retried once")
    check(np.array_equal(ftoks, dual_toks), "fused fault run changed tokens")
    phase_profile(srv, params, prompt, "a fused")


def _launch_calls(evs) -> int:
    """Kernel launch calls the host made, from profiler events."""
    from torch.autograd import DeviceType
    return sum(e.count for e in evs if e.device_type == DeviceType.CPU
               and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))


def device_profile(fn):
    """Run fn() once under torch.profiler (which itself slows the host).
    Returns (wall ms, device-busy ms, kernels the device ran, per-kernel
    events, kernel launch calls the host made). CUDA activity alone still
    records the host's launch calls, and post-processes in about a third
    of the time that adding the host's op events takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    avg = prof.key_averages()
    kern = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    return (wall_ms, busy_ms, sum(e.count for e in kern), kern,
            _launch_calls(avg))


def phase_profile(srv, params, prompt, label: str, steps: int = 17):
    """Where a protected generate's time goes: device-busy share of the
    wall and the kernels that take the device time."""
    wall_ms, busy_ms, launches, kern, calls = device_profile(
        lambda: srv.generate(params, {"tokens": prompt}, steps=steps))
    print(f"profile of {label} generate ({steps - 1} decode steps, "
          f"profiler on): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
          f" ({100 * busy_ms / wall_ms:.1f}%), {launches} kernels recorded "
          f"on the device ({launches / (steps - 1):.0f} per decode step incl. "
          f"prefill), {calls} launch calls by the host "
          f"({calls / (steps - 1):.0f} per decode step incl. prefill)",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def phase_k3(kab):
    """K3 against its plain version (`torch.matmul` in f32, TF32 off) and
    bitwise against the first (SIMT) K3 body on the encoded operands of the
    qwen2-0.5b MLP products of 4 x 256 prompt tokens, of the engine phase's
    step and of the CPU tests' shapes; then bench_abft's three costs."""
    from repro_torch.abft.ref import checksum_encode, verify_and_correct
    from repro_torch.core.fingerprint import fingerprints_equal
    from repro_torch.kernels import ops
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the plain f32 product would not be f32")
    dev = torch.device("cuda")
    tokens = BATCH * PROMPT_LEN
    entry = None
    for m, n, k in ((tokens, 896, 4864), (tokens, 4864, 896),
                    (ENGINE_M, ENGINE_N, ENGINE_N), (24, 16, 20), (7, 5, 3)):
        gen = torch.Generator(device=dev).manual_seed(m + n + k)
        a = torch.randn(m, n, generator=gen, device=dev)
        b = torch.randn(n, k, generator=gen, device=dev)
        a_c, b_r = checksum_encode(a, b)
        got = kab.matmul_kernel(a_c, b_r)
        again = kab.matmul_kernel(a_c, b_r)
        simt = kab.matmul_simt_oracle(a_c, b_r)
        want = kab.matmul_plain(a_c, b_r)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        _, rep = verify_and_correct(got, n)
        print(f"K3 ({m + 1}x{n})x({n}x{k + 1}): max |K3 - plain| {err:.3e} "
              f"= {rel:.3e} of max |plain|, two launches bitwise "
              f"{'equal' if torch.equal(got, again) else 'DIFFERENT'}, "
              f"bitwise {'equal' if torch.equal(got, simt) else 'DIFFERENT'}"
              f" to the SIMT body, verify detected {bool(rep.detected)}",
              flush=True)
        check(rel <= 1e-5, f"K3 off plain by {rel} of max at {m}x{n}x{k}")
        check(torch.equal(got, again), f"K3 not bitwise repeatable at "
              f"{m}x{n}x{k}")
        check(torch.equal(got, simt), f"K3 differs from the SIMT body at "
              f"{m}x{n}x{k}")
        check(not bool(rep.detected), f"clean K3 product detected at "
              f"{m}x{n}x{k}: {rep}")
        if entry is not None:
            continue
        M, N = m + 1, k + 1
        ms = device_ms(lambda: kab.matmul_kernel(a_c, b_r), 50)
        call_ms = cuda_ms(lambda: kab.matmul_kernel(a_c, b_r), 50)
        simt_ms = device_ms(lambda: kab.matmul_simt_oracle(a_c, b_r), 50)
        plain_ms = device_ms(lambda: kab.matmul_plain(a_c, b_r), 50)
        lib_ms = device_ms(lambda: torch.matmul(a_c, b_r), 50)
        flops = 2.0 * M * n * N
        b_ms, b_by = bound(4.0 * (M * n + n * N + M * N), flops,
                           F32_FLOPS_PER_S)
        print(f"K3 at ({M}x{n})x({n}x{N}): device {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s; per call {call_ms:.4f} ms),"
              f" the SIMT body {simt_ms:.4f}"
              f" ms ({flops / simt_ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, torch.matmul f32 {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}, f32 rate)", flush=True)

        def checksummed():
            kab.abft_matmul(a, b)

        def duplicated():     # the sequential backend's cost per kernel
            fingerprints_equal(ops.fingerprint(kab.matmul_kernel(a, b)),
                               ops.fingerprint(kab.matmul_kernel(a, b)))

        t = {"plain": cuda_ms(lambda: kab.matmul_kernel(a, b), 30),
             "checksummed": cuda_ms(checksummed, 30),
             "duplicated": cuda_ms(duplicated, 30)}
        print(f"K3 detection cost at {m}x{n}x{k} (bench_abft's rows): "
              f"plain K3 {t['plain']:.4f} ms, checksummed (encode + K3 + "
              f"verify) {t['checksummed']:.4f} ms = "
              f"{t['checksummed'] / t['plain']:.3f}x, duplicated (K3 twice "
              f"+ K1 compare) {t['duplicated']:.4f} ms = "
              f"{t['duplicated'] / t['plain']:.3f}x", flush=True)
        wall_ms, busy_ms, launches, _, _ = device_profile(checksummed)
        print(f"one checksummed call, profiled: wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms, {launches} kernel launches",
              flush=True)
        entry = {"name": "abft_matmul", "route": "cuda",
                 "source": "src/repro_torch/csrc/abft_matmul.cu",
                 "replaces": "src/repro/abft/kernels.py:44",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


def phase_campaign(kab):
    """The 12 ABFT scenarios replayed through K3 on the card."""
    from repro_torch.core.scenarios import run_abft_campaign
    rows = run_abft_campaign(matmul=kab.abft_matmul, device="cuda")
    print("ABFT campaign through K3: " + ", ".join(
        f"{r['sid']}:{r['obs']}{'' if r['match'] else '(MISMATCH)'}"
        for r in rows), flush=True)
    check(len(rows) == 12 and all(r["match"] for r in rows),
          f"campaign rows off their prediction: {rows}")


CAMPAIGN_N = 4096          # the large campaign: 64 MB matrices
# the paper's exemplars (tests/test_scenarios.py) and the 3-rollback one:
# (window, process, datum) -> (effect, p_det, p_rec, n_roll)
CAMPAIGN_EXEMPLARS = {
    ("CK0", "M", "A"): ("TDC", "SCATTER", "CK0", 1),
    ("BCAST", "W", "C"): ("LE", None, None, 0),
    ("GATHER", "M", "C"): ("FSC", "VALIDATE", "CK2", 2),
    ("CK2", "W", "i"): ("TOE", "GATHER", "CK2", 1),
    ("SCATTER", "W", "A"): ("TDC", "GATHER", "CK0", 3),
}


def phase_scenarios(kfp):
    """The paper's 64-scenario replica campaign (Table 2) on the card: the
    dual-replica Master/Worker matmul with its memory on the card, each
    send validated by two K1 fingerprints. At the reference's n=8 (2
    workers) every row matches `predict` and the exemplars read as the
    paper's; at n=4096 (64 MB matrices) the same 64 predictions hold, every
    result is within the f32 error bound of the f64 truth, and every
    recovered run's C is bitwise equal to the clean run's in both
    replicas. K1 is held against its plain version at the campaign's leaf
    shapes. Returns K1's launches in the two campaigns."""
    from repro_torch.core.fingerprint import leaf_fingerprints, \
        pytree_fingerprint
    from repro_torch.core.scenarios import (MatmulTestApp, all_scenarios,
                                            campaign_row)

    launches = 0
    for n in (8, CAMPAIGN_N):
        app = MatmulTestApp(n=n, workers=2, device="cuda")
        clean_obs = app.run(None)
        clean = [m["M.C"].clone() for m in app.last_mem]
        check(clean_obs.correct_result and clean_obs.n_roll == 0,
              f"campaign n={n}: the clean run is wrong ({clean_obs})")
        torch.cuda.synchronize()
        kfp.launch_count.reset()
        t0 = time.time()
        rows, bitwise = [], True
        for s in all_scenarios():
            row = campaign_row(s, app.run(s))
            rows.append(row)
            bitwise &= all(torch.equal(m["M.C"], c)
                           for m, c in zip(app.last_mem, clean))
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches += kfp.launch_count.n
        bad = [r for r in rows if not r["match"]]
        effects = {}
        for r in rows:
            effects[r["obs"]["effect"]] = effects.get(r["obs"]["effect"], 0) + 1
        print(f"replica campaign n={n} (2 workers): {64 - len(bad)}/64 rows "
              f"match predict, effects {effects}, every C bitwise equal to "
              f"the clean run's: {bitwise}; {secs:.2f} s, K1 launches "
              f"{kfp.launch_count.n}", flush=True)
        check(not bad, f"campaign n={n}: rows off their prediction: {bad[:3]}")
        check(bitwise, f"campaign n={n}: a run's C differs from the clean "
              "run's")
        for r in rows:
            want = CAMPAIGN_EXEMPLARS.get((r["window"], r["process"],
                                           r["datum"]))
            if want is not None:
                o = r["obs"]
                got = (o["effect"], o["p_det"], o["p_rec"], o["n_roll"])
                check(got == want and o["correct_result"],
                      f"campaign n={n} exemplar {r['sid']}: {got} != {want}")
        if n == 8:
            print("campaign exemplars (sid: effect, P_det, P_rec, N_roll): "
                  + "; ".join(f"{r['sid']}: {r['obs']['effect']}, "
                              f"{r['obs']['p_det']}, {r['obs']['p_rec']}, "
                              f"{r['obs']['n_roll']}" for r in rows
                              if (r["window"], r["process"], r["datum"])
                              in CAMPAIGN_EXEMPLARS), flush=True)
    # K1 at the campaign's send shapes against its plain version
    for what, x in (("M.A (4096, 4096) f32", app.A0),
                    ("W0.C (2048, 4096) f32", clean[0][:CAMPAIGN_N // 2])):
        got = _k1_words(leaf_fingerprints([x])[0])
        want = _k1_words(pytree_fingerprint([x])[0])
        check(np.array_equal(got[[0, 1, 3]], want[[0, 1, 3]]),
              f"K1 on the campaign's {what} differs from plain")
        print(f"K1 on the campaign's {what}: h1/h2/absmax bitwise equal to "
              f"the plain version", flush=True)
    return launches


def _engine_workload():
    """x (1024, 896) of small integers and W (896, 896) a permutation
    matrix, so K3's products and every checksum sum are exact in f32: a
    clean step's residuals are exactly 0 and a forward correction restores
    the element's bits exactly. (With random real data the corrected
    element keeps the clean residual's rounding, ~100 ulp at n = 896.)
    Returns x, W, the fault's target and the exact final x of a clean
    run. The target is the first element of the product at the fault
    step whose diagonal run of 3 lies in 2 <= |v| < 256, where flipping
    FAULT_BIT multiplies by 256 — far above the eps32 threshold. (At
    n = 896 a bit-21 flip, |delta| <= |v|/2, is below the threshold
    16 eps (n + m) sum|row| ~ 3 |v| and escapes, by the reference's rule.)"""
    rs = np.random.RandomState(0)
    perm = rs.permutation(ENGINE_N)
    w = np.zeros((ENGINE_N, ENGINE_N), np.float32)
    w[perm, np.arange(ENGINE_N)] = 1.0           # (x @ w)[:, j] = x[:, perm[j]]
    x0 = rs.randint(2, 6, (ENGINE_M, ENGINE_N))
    xs = [x0.astype(np.int64)]
    for t in range(ENGINE_STEPS):                # exact integer trajectory
        xs.append(xs[-1] + (t + 1) - xs[-1][:, perm])
    check(max(int(np.abs(x).max()) for x in xs) < 2 ** 24 // (ENGINE_M + 1),
          "engine trajectory too large for exact f32 checksum sums")
    ok = np.abs(xs[ENGINE_FAULT_STEP][:, perm])
    ok = (ok >= 2) & (ok < 256)
    i, j = next((i, j) for i in range(ENGINE_M - 2) for j in range(ENGINE_N - 2)
                if ok[i, j] and ok[i + 1, j + 1] and ok[i + 2, j + 2])
    return (x0.astype(np.float32), w, i * (ENGINE_N + 1) + j,
            xs[-1].astype(np.float32))


def phase_engine(kab):
    """SedarEngine + AbftExecutor whose step updates x with abft_matmul
    (K3) — clean, a single-element fault corrected forward, a 3-element
    fault retried — and the same loop under `sequential`, whose two
    replicas run K3 on the unencoded operands. Returns K3's launches in
    the three protected runs."""
    from repro_torch.configs import SedarConfig
    from repro_torch.core.engine import BoundarySchedule
    from repro_torch.core.fingerprint import pytree_fingerprint_fused
    from repro_torch.core.injection import (InjectionSpec,
                                            MemoryInjectionFlag,
                                            make_kernel_fault)
    from repro_torch.core.policy import make_engine
    from repro_torch.core.recovery import RetryRecovery, SafeStop

    dev = torch.device("cuda")
    x0_np, w_np, target, final_np = _engine_workload()
    x0, W = torch.from_numpy(x0_np).to(dev), torch.from_numpy(w_np).to(dev)

    def engine(backend, spec=None, retry=False):
        def abft_step(state, batch, replica_id, armed):
            inj = (make_kernel_fault(spec, step=state["step"], armed=armed)
                   if spec is not None else None)
            delta, report = kab.abft_matmul(state["x"], W, inject=inj)
            return ({"x": state["x"] + batch - delta,
                     "step": state["step"] + 1}, None, None, report)

        def seq_step(state, batch, replica_id, armed):
            delta = kab.matmul_kernel(state["x"], W)
            return ({"x": state["x"] + batch - delta,
                     "step": state["step"] + 1},
                    pytree_fingerprint_fused({"d": delta}), None)

        return make_engine(
            SedarConfig(), backend=backend,
            step_fn=abft_step if backend == "abft" else seq_step,
            state_fp_fn=lambda s: pytree_fingerprint_fused({"x": s["x"]}),
            schedule=BoundarySchedule(commit_interval=1, validate_interval=0),
            recovery=(RetryRecovery(max_retries=4) if retry
                      else SafeStop(notify=lambda e: None)),
            inj_spec=spec, inj_flag=MemoryInjectionFlag(),
            notify=lambda e: None)

    def drive(eng):
        dual = eng.executor.init_dual({"x": x0.clone(), "step": 0})
        eng.reset()
        while dual["r0"]["step"] < ENGINE_STEPS:
            step = dual["r0"]["step"]
            out = eng.run_protected_step(
                dual, torch.full_like(x0, float(step + 1)), step)
            dual = out.dual
            if out.event is not None:
                dual = eng.on_detection(out.event, dual)
        torch.cuda.synchronize()
        return dual["r0"]["x"]

    def events(eng):
        return [(e.step, e.boundary, e.effect,
                 bool(e.detail.get("abft_corrected"))) for e in eng.detections]

    kab.matmul_launch_count.reset()
    clean_eng = engine("abft")
    clean = drive(clean_eng)
    spec1 = InjectionSpec(leaf_idx=0, flat_idx=target, bit=FAULT_BIT,
                          step=ENGINE_FAULT_STEP, target="kernel")
    fix_eng = engine("abft", spec1)
    fixed = drive(fix_eng)
    spec3 = InjectionSpec(leaf_idx=0, flat_idx=target, bit=FAULT_BIT,
                          step=ENGINE_FAULT_STEP, target="kernel", n_elems=3)
    retry_eng = engine("abft", spec3, retry=True)
    retried = drive(retry_eng)
    launches = kab.matmul_launch_count.n
    print(f"engine through K3 (x {ENGINE_M}x{ENGINE_N}, {ENGINE_STEPS} "
          f"steps, fault at step {ENGINE_FAULT_STEP}, flat index {target}, "
          f"bit {FAULT_BIT}): clean {events(clean_eng)}, x bitwise equal "
          f"to the exact trajectory "
          f"{np.array_equal(clean.cpu().numpy(), final_np)}; single "
          f"{events(fix_eng)} -> {[r['kind'] for r in fix_eng.recoveries]}, "
          f"x bitwise {torch.equal(fixed, clean)}; three {events(retry_eng)} "
          f"-> {[r['kind'] for r in retry_eng.recoveries]}, x bitwise "
          f"{torch.equal(retried, clean)}; K3 launches {launches}",
          flush=True)
    check(not clean_eng.detections, "clean engine run detected")
    check(np.array_equal(clean.cpu().numpy(), final_np),
          "clean engine x differs from the exact integer trajectory")
    check(events(fix_eng) == [(ENGINE_FAULT_STEP, "commit", "TDC", True)]
          and [(r["kind"], r["rollbacks"]) for r in fix_eng.recoveries]
          == [("abft_correct", 0)], "single fault not corrected forward")
    check(torch.equal(fixed, clean), "forward-corrected x differs from clean")
    check(events(retry_eng) == [(ENGINE_FAULT_STEP, "commit", "TDC", False)]
          and [r["kind"] for r in retry_eng.recoveries] == ["retry"],
          "3-element fault not retried once")
    check(torch.equal(retried, clean), "retried x differs from clean")
    check(launches == 3 * ENGINE_STEPS + 1,
          f"K3 launched {launches} != {3 * ENGINE_STEPS + 1} times")

    rate = {}
    for backend in ("sequential", "abft", "abft", "sequential"):
        eng = engine(backend)
        drive(eng)                                   # warm
        t0 = time.perf_counter()
        for _ in range(3):
            drive(eng)
        rate.setdefault(backend, []).append(
            3 * ENGINE_STEPS / (time.perf_counter() - t0))
    print("engine steps/s (host clock, 3 x 8 steps, in turns seq, abft, "
          "abft, seq): " + ", ".join(
              f"{b} {' / '.join(f'{r:.1f}' for r in v)}"
              for b, v in rate.items()), flush=True)
    return launches


def phase_k4(kab, kfa, report):
    """K4 against its plain version (flash_attention_plain on the encoded V)
    in f32 at qwen2-0.5b prefill shapes, two launches bitwise equal, and the
    checksum verdicts; then the API `abft_flash_attention` 24 times on the
    S=256 inputs, held against its oracle `abft_attention_ref`. No model
    path calls K4, in the port or in the reference: its counted launches
    are these API calls. `report` is the build's ptxas report."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.abft.ref import (abft_attention_ref,
                                      attention_checksum_encode,
                                      attention_verify)
    from repro_torch.core.injection import InjectionSpec, make_kernel_fault
    dev = torch.device("cuda")
    H, KV, hd = 14, 2, 64
    entry = None
    for S in (PROMPT_LEN, 2048):
        gen = torch.Generator(device=dev).manual_seed(S + 1)
        q = torch.randn(BATCH, H, S, hd, generator=gen, device=dev)
        k = torch.randn(BATCH, KV, S, hd, generator=gen, device=dev)
        v = torch.randn(BATCH, KV, S, hd, generator=gen, device=dev)
        v_aug = attention_checksum_encode(v)
        got = kab.flash_attention_ck(q, k, v_aug, causal=True)
        again = kab.flash_attention_ck(q, k, v_aug, causal=True)
        want = kfa.flash_attention_plain(q, k, v_aug, causal=True)
        diff = (got - want).abs()
        err = float(diff.max())
        over = float((diff - 1e-5 * want.abs()).max())
        _, rep = attention_verify(got, S)
        flat = int(got[..., :hd].abs().argmax())     # the largest data lane
        target = flat // hd * (hd + 1) + flat % hd
        spec = InjectionSpec(leaf_idx=0, flat_idx=target, bit=23, step=0,
                             target="kernel")
        _, frep = attention_verify(
            make_kernel_fault(spec, step=0, armed=True)(got), S)
        same = "equal" if torch.equal(got, again) else "DIFFERENT"
        print(f"K4 S={S}: max abs err {err:.3e} vs plain (f32), two "
              f"launches bitwise {same}, clean verify detected "
              f"{bool(rep.detected)}, bit-23 flip of the "
              f"largest output: detected {bool(frep.detected)}, "
              f"uncorrectable {bool(frep.uncorrectable)}", flush=True)
        check(bool(torch.isfinite(got).all()), f"K4 non-finite at S={S}")
        check(over <= 1e-5, f"K4 off plain beyond atol 1e-5 + rtol 1e-5 at "
              f"S={S} (max abs err {err})")
        check(torch.equal(got, again), f"K4 not bitwise repeatable at S={S}")
        check(not bool(rep.detected), f"clean K4 output detected at S={S}")
        check(bool(frep.detected) and bool(frep.uncorrectable),
              f"K4 output fault not detected as uncorrectable at S={S}")
        ms = device_ms(lambda: kab.flash_attention_ck(q, k, v_aug,
                                                      causal=True), 30)
        call_ms = cuda_ms(lambda: kab.flash_attention_ck(q, k, v_aug,
                                                         causal=True), 30)
        plain_ms = device_ms(lambda: kfa.flash_attention_plain(
            q, k, v_aug, causal=True), 5)
        lib_ms, lib_backend = None, None
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(q, k, v_aug, is_causal=True,
                                                   enable_gqa=True)
                    torch.cuda.synchronize()
                    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v_aug, is_causal=True, enable_gqa=True), 10)
                lib_backend = backend.name
                break
            except RuntimeError:
                continue
        pairs = S * (S + 1) // 2
        flops = 2.0 * BATCH * H * pairs * (hd + hd + 1)   # QK^T and PV
        nbytes = 4.0 * BATCH * S * (H * hd + KV * hd + KV * (hd + 1)
                                    + H * (hd + 1))
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
        print(f"K4 S={S}: device {ms:.4f} ms (per call {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, "
              f"sdpa f32 on "
              f"(q, k, v_aug) {lib_ms if lib_ms is None else f'{lib_ms:.4f}'}"
              f" ms (backend that took hd+1 with GQA: {lib_backend}), bound "
              f"{b_ms:.5f} ms ({b_by}, f32 rate), "
              f"{flops / ms / 1e9:.2f} TFLOP/s on the function's count",
              flush=True)
        if S == PROMPT_LEN:
            entry = {"name": "abft_flash_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/abft/kernels.py:122",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            path = (q, k, v)
    for hd_ in (64, 16):
        key = f"flash_fwd_f32<{hd_},1>"
        regs, spill, _ = report.get(key, (None, None, None))
        # csrc/flash_attention.cu f32_smem_bytes: Q, two K/V stages, P
        smem = (5 * 64 * (hd_ + 4) + 64 * 68) * 4
        print(f"K4 {key}: {regs} registers, {spill} bytes spilled (ptxas), "
              f"{smem} bytes of dynamic shared memory per block", flush=True)
    layers = 24
    kab.flash_ck_launch_count.reset()
    outs = [kab.abft_flash_attention(*path, causal=True)
            for _ in range(layers)]
    entry["launches"] = kab.flash_ck_launch_count.n
    detected = [bool(rep.detected) for _, rep in outs]
    want, _ = abft_attention_ref(*path, causal=True)     # the oracle
    over = max(float(((o - want).abs() - 1e-5 * want.abs()).max())
               for o, _ in outs)
    print(f"K4 API: abft_flash_attention x{layers} at B={BATCH} "
          f"S={PROMPT_LEN}: launches {entry['launches']}, detections "
          f"{sum(detected)}, max excess over atol/rtol 1e-5 against "
          f"abft_attention_ref {over:.3e}", flush=True)
    check(entry["launches"] == layers and not any(detected),
          "K4 API launches or verdicts off")
    check(over <= 1e-5, "abft_flash_attention off abft_attention_ref beyond "
          "atol 1e-5 + rtol 1e-5")
    return entry


def phase_abft_serve(kfp, kfa, main):
    """Replica-free serving of the main path's model: clean abft and hybrid
    generates under sync-debug "error" (tokens equal the unprotected run's,
    no detection, exact host reads), then a kernel fault corrected forward.
    Then a profile of an abft generate and the four backends' decode
    ms/step in turns."""
    from repro_torch.configs import RunConfig, SedarConfig
    from repro_torch.core import hostsync
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server

    dev = torch.device("cuda")
    cfg, params, prompt = main["cfg"], main["params"], main["prompt"]
    interval = 8
    rc = RunConfig(model=cfg, sedar=SedarConfig(
        param_validate_interval=interval))
    for backend in ("abft", "hybrid"):
        srv = make_server(rc, backend=backend, device=dev)
        srv.generate(params, {"tokens": prompt}, steps=2)        # warm-up
        torch.cuda.synchronize()
        kfp.launch_count.reset()
        kfa.launch_count.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with hostsync.count_transfers() as st:
                toks, rep = srv.generate(params, {"tokens": prompt},
                                         steps=STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = {"fingerprint": kfp.launch_count.n,
                  "flash_attention": kfa.launch_count.n}
        checks = (0 if backend == "abft" else
                  sum(1 for p in range(PROMPT_LEN + 1, PROMPT_LEN + STEPS - 1)
                      if p % interval == 0))
        want = {"abft_verdict": STEPS - 1, "token_emit": STEPS}
        if checks:
            want["state_validate"] = checks
        print(f"{backend} serving: launches {counts}; host reads "
              f"{st.by_label}; decode {decode_ms(rep):.2f} ms/step, "
              f"{rep.tokens_emitted / rep.wall_s:.1f} tokens/s", flush=True)
        check(np.array_equal(toks, main["tokens"]),
              f"{backend} tokens differ from the unprotected run")
        check(not rep.detections and not rep.stopped,
              f"clean {backend} run detected "
              f"{[str(e) for e in rep.detections]}")
        check(st.by_label == want, f"{backend} host reads {st.by_label}")
        check(counts["flash_attention"] == cfg.num_layers,
              f"{backend}: K2 launched {counts['flash_attention']} times")
        check(counts["fingerprint"] == (0 if backend == "abft"
                                        else STEPS - 1 + checks),
              f"{backend}: K1 launched {counts['fingerprint']} times")

    V = cfg.vocab_size
    spec = InjectionSpec(leaf_idx=0, flat_idx=1 * (V + 1) + 5, bit=30,
                         step=PROMPT_LEN + 5, replica=0, target="kernel")
    fsrv = make_server(rc, backend="abft", device=dev, inj_spec=spec)
    ftoks, frep = fsrv.generate(params, {"tokens": prompt}, steps=STEPS)
    events = [(e.step, e.boundary, e.effect,
               bool(e.detail.get("abft_corrected"))) for e in frep.detections]
    kinds = [r["kind"] for r in fsrv.engine.recoveries]
    print(f"abft kernel-fault run: detections {events}, recoveries {kinds}, "
          f"retries {frep.retries}", flush=True)
    check(events == [(PROMPT_LEN + 5, "commit", "TDC", True)]
          and kinds == ["abft_correct"] and frep.retries == 0,
          "kernel fault not corrected forward")
    check(np.array_equal(ftoks, main["tokens"]),
          "kernel-fault run changed the tokens")
    phase_profile(make_server(rc, backend="abft", device=dev), params,
                  prompt, "an abft")
    phase_profile(make_server(rc, backend="hybrid", device=dev), params,
                  prompt, "a hybrid")

    # decode ms/step of the five backends, in turns (ABBA), so that the
    # shared host's drift hits each alike
    servers = {b: make_server(rc, backend=b, device=dev)
               for b in ("none", "sequential", "fused", "abft", "hybrid")}
    times = {}
    for b in list(servers) + list(servers)[::-1]:
        _, rep = servers[b].generate(params, {"tokens": prompt}, steps=STEPS)
        times.setdefault(b, []).append(decode_ms(rep))
    print("decode ms/step, same call, in turns none, sequential (dual), "
          "fused, abft, hybrid, then back: " + "; ".join(
              f"{b} {' / '.join(f'{t:.2f}' for t in v)}"
              for b, v in times.items()), flush=True)


SERVE_SLOTS = 4
SERVE_LAG = 8
SERVE_FAULT_TICK = 5
SERVE_MAX_LEN = 256 + 32 + 8
SERVE_TURN_STEPS = 24
SERVE_PROFILE_STEPS = 8
BF16_EXP_BIT = 14   # the top exponent bit of a bf16, bit 30 of an f32


def serve_requests():
    """The serve phase's traffic: 8 requests arriving at 0.5 per decode
    tick, prompts of 96, 200 or 256 tokens, budgets of 16 or 32 tokens."""
    from repro_torch.runtime.scheduler import synthetic_requests
    return synthetic_requests(8, arrival_rate=0.5,
                              prompt_lengths=(96, 200, 256),
                              max_new_choices=(16, 32), vocab=151936, seed=0)


def _top2_margin(srv, params, req, idx: int) -> float:
    """Top-2 logit margin at token `idx` of `req`'s stream, replaying its
    prompt and its first `idx` tokens at B=1 (printed when streams differ)."""
    dev = torch.device("cuda")
    toks = torch.tensor(np.concatenate([req.prompt, req.tokens[:idx]])
                        [None], device=dev)
    logits, _ = srv.model.prefill(params, {"tokens": toks}, SERVE_MAX_LEN)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def phase_serve(kfp, kfa, main):
    """Continuous-batching `serve()` of the main path's model at full width
    (slot scheduler, packed protected admission through K1 lanes and K2,
    per-slot K1 fingerprints), every serving call under sync-debug
    "error": unprotected, dual at lag 1 and at lag 8 (drain on), then a
    transient slot fault at lag 1 and lag 8, a stuck slot bit and an
    admission fault; the same under `fused` (streams equal sequential lag
    1's); abft and hybrid clean, with a kernel-domain slot fault and an
    admission kernel fault corrected forward; K1's row-limit leaves and K2
    at the fused pack shapes against their plain versions; every backend
    in turns; dual and fused lag-1 profiles. Returns the kernels' launches
    in the dual lag-1 run."""
    import contextlib

    from repro_torch.configs import RunConfig
    from repro_torch.core import hostsync
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.device import upload
    from repro_torch.runtime.scheduler import ttft_percentiles_ms

    dev = torch.device("cuda")
    cfg, params = main["cfg"], main["params"]
    rc = RunConfig(model=cfg)
    name = torch.cuda.get_device_name(0)
    t_phase = time.time()

    def since() -> str:
        return f"[serve phase +{time.time() - t_phase:.1f} s]"

    @contextlib.contextmanager
    def strict():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def serve(srv, lag, counted=False, **kw):
        kfp.launch_count.reset()
        kfa.launch_count.reset()
        with strict(), hostsync.count_transfers(cross_thread=True) as st:
            out, rep = srv.serve(params, serve_requests(), slots=SERVE_SLOTS,
                                 validate_lag=lag, max_len=SERVE_MAX_LEN,
                                 **kw)
        torch.cuda.synchronize()
        counts = {"fingerprint": kfp.launch_count.n,
                  "flash_attention": kfa.launch_count.n}
        return out, rep, st.by_label, counts

    def streams(out):
        return {r.rid: list(r.tokens) for r in out}

    plain = make_server(rc, backend="none", device=dev)
    dual = make_server(rc, dual=True, device=dev)
    out0, rep0, reads0, counts0 = serve(plain, 1)
    clean = streams(out0)
    check(sorted(rep0.completed) == list(range(8)) and not rep0.detections,
          f"unprotected serve: completed {rep0.completed}")
    check(all(len(t) == r.max_new_tokens and all(0 <= x < cfg.vocab_size
                                                 for x in t)
              for r, t in zip(out0, clean.values())),
          "unprotected serve: stream lengths or token ids off")
    runs = {}
    for lag in (1, SERVE_LAG):
        out, rep, reads, counts = serve(dual, lag)
        runs[lag] = (out, rep, reads, counts)
        check(streams(out) == clean,
              f"dual lag {lag} streams differ from the unprotected run")
        check(not rep.detections and sorted(rep.completed) == list(range(8)),
              f"clean dual lag {lag}: {[str(e) for e in rep.detections]}")
        check(counts["flash_attention"] == 2 * cfg.num_layers
              * rep.prefill_packs, f"lag {lag}: K2 launched "
              f"{counts['flash_attention']} for {rep.prefill_packs} packs")
        lanes = counts["fingerprint"] - 2 * SERVE_SLOTS * rep.steps
        check(2 * rep.prefill_packs <= lanes
              <= 2 * 4 * rep.prefill_packs,
              f"lag {lag}: K1 launched {counts['fingerprint']} for "
              f"{rep.steps} steps and {rep.prefill_packs} packs")
        print(f"serve dual lag {lag} on {name}: {rep.steps} steps, "
              f"{rep.prefill_packs} packs, {rep.tokens_emitted} tokens, "
              f"{rep.tokens_per_s:.1f} tokens/s, goodput "
              f"{rep.goodput_tokens_per_step:.3f} tokens/step, "
              f"{rep.wall_s / rep.steps * 1e3:.2f} ms/step (wall / steps, "
              f"admission included), TTFT p50/p99 "
              + "/".join(f"{v:.2f}" for v in ttft_percentiles_ms(out))
              + f" ms; launches {counts} (K1: {2 * SERVE_SLOTS} per decode "
              f"step, {lanes} lanes in {rep.prefill_packs} packs; K2: "
              f"{2 * cfg.num_layers} per pack); host reads {reads} {since()}",
              flush=True)
    rep1, reads1 = runs[1][1], runs[1][2]
    check(reads1 == {"prefill_emit": 2 * rep1.prefill_packs,
                     "commit_compare": rep1.steps,
                     "token_emit": 2 * rep1.steps},
          f"lag 1 host reads {reads1}")
    rep8, reads8 = runs[SERVE_LAG][1], runs[SERVE_LAG][2]
    check(set(reads8) == {"prefill_emit", "token_emit"}
          and reads8["prefill_emit"] == 2 * rep8.prefill_packs
          and reads8["token_emit"] % 3 == 0
          and reads8["token_emit"] <= 3 * (rep8.steps // SERVE_LAG + 2),
          f"lag {SERVE_LAG} host reads {reads8}")
    print(f"serve unprotected on {name}: {rep0.steps} steps, "
          f"{rep0.tokens_per_s:.1f} tokens/s, goodput "
          f"{rep0.goodput_tokens_per_step:.3f} tokens/step, "
          f"{rep0.wall_s / rep0.steps * 1e3:.2f} ms/step, TTFT p50/p99 "
          + "/".join(f"{v:.2f}" for v in ttft_percentiles_ms(out0))
          + f" ms; launches {counts0}", flush=True)
    ring = dual._batch_engines[(SERVE_SLOTS, SERVE_MAX_LEN, SERVE_LAG)][1]
    slice_bytes = sum(2 * cfg.num_layers * SERVE_MAX_LEN * cfg.num_kv_heads
                      * cfg.head_dim for _ in "kv") + 16
    print(f"SlotRing after the lag-{SERVE_LAG} run: {ring.nbytes()} device "
          f"bytes in {sum(len(ring.versions(s)) for s in range(SERVE_SLOTS))}"
          f" snapshots; at most {SERVE_SLOTS * 4 * slice_bytes} "
          f"({SERVE_SLOTS} slots x 4 versions x {slice_bytes})", flush=True)

    # K1 at the serve path's shapes against its plain version: one slot's
    # bf16 logits row, and one admission lane (a pack row's strided cache
    # views and its logits row)
    from repro_torch.core.fingerprint import (fingerprint_in_place,
                                              lane_fingerprints,
                                              pack_tree_u32,
                                              slot_fingerprints)
    V = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(15)
    logits = (torch.randn(SERVE_SLOTS, V, generator=gen, device=dev)
              * 3).bfloat16()
    active = torch.ones(SERVE_SLOTS, dtype=torch.bool, device=dev)
    got = slot_fingerprints(logits, active)
    want = slot_fingerprints(logits.cpu(), active.cpu())
    check(torch.equal(got[:, :2].cpu(), want[:, :2]),
          "K1 slot fingerprints differ from the plain version")
    shape = (cfg.num_layers, 2, SERVE_MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
    cache = {n: torch.randn(shape, generator=gen, device=dev).bfloat16()
             for n in "kv"}
    rows = {n: c.transpose(0, 1).unsqueeze(2) for n, c in cache.items()}
    lanes = lane_fingerprints(logits[:2], rows)
    for i in range(2):
        packed = pack_tree_u32({"cache": {n: r[i] for n, r in rows.items()},
                                "logits": logits[i]})
        check(torch.equal(lanes[i, :2],
                          kfp.fingerprint_plain(packed)[:2]),
              f"K1 lane {i} differs from pack + plain")
    lane_leaves = [rows["k"][1], rows["v"][1], logits[1]]
    row_ms = device_ms(lambda: fingerprint_in_place([logits[1]]), 200)
    lane_ms = device_ms(lambda: fingerprint_in_place(lane_leaves), 200)
    row_bound, _ = bound(2 * V + 16, 0)
    lane_bound, _ = bound(2 * 2 * cfg.num_layers * SERVE_MAX_LEN
                          * cfg.num_kv_heads * cfg.head_dim + 2 * V + 16, 0)
    print(f"K1 on serve's shapes: slot rows and lanes bitwise equal (h1, h2)"
          f" to the plain version; one slot row (bf16, {V}) device "
          f"{row_ms:.4f} ms, bound {row_bound:.5f} ms (bytes); one lane "
          f"(a pack row's k and v views at a stride + its logits row) "
          f"device {lane_ms:.4f} ms, bound {lane_bound:.5f} ms (bytes) "
          f"{since()}", flush=True)

    # K2 at the pack shapes admission gives it: K = 1, 2 or 4 prompts in
    # the buckets this traffic uses (96 -> 128; 200, 256 -> 256)
    for K in (1, 2, 4):
        for S in (128, 256):
            _, _, _, err, row_err = check_k2(kfa, K, S, 100 * K + S,
                                             f"pack K={K} S={S}")
            print(f"K2 pack K={K} S={S}: max abs err {err:.3e}, per row's "
                  f"largest value {row_err:.3e} vs plain (bf16), two "
                  f"launches bitwise equal", flush=True)

    # each request's stream against generate() at B=1 on its prompt
    prompts = [upload(r.prompt[None].astype(np.int64), dev) for r in out0]
    with strict():
        for r, prompt in zip(out0, prompts):
            toks, _ = plain.generate(params, {"tokens": prompt},
                                     steps=r.max_new_tokens,
                                     max_len=SERVE_MAX_LEN)
            got = [int(x) for x in toks[0]]
            if got != clean[r.rid]:
                i = next(k for k, (a, b) in enumerate(zip(got,
                                                          clean[r.rid]))
                         if a != b)
                torch.cuda.set_sync_debug_mode(0)
                print(f"request {r.rid}: first difference at token {i}, "
                      f"top-2 margin there "
                      f"{_top2_margin(plain, params, r, i):.4g}", flush=True)
                fail(f"serve stream of request {r.rid} differs from B=1 "
                     f"generate()")
    print("each request's served stream equals B=1 generate() on its "
          f"prompt {since()}", flush=True)

    # fault campaigns: the clean streams for every completed request
    slot_fault = dict(leaf_idx=1, flat_idx=7, bit=BF16_EXP_BIT,
                      step=SERVE_FAULT_TICK, replica=1, target="slot")

    def campaign(spec, lag, backend="sequential", cfg_run=rc, **kw):
        srv = make_server(cfg_run, backend=backend, device=dev,
                          inj_spec=InjectionSpec(**spec), **kw)
        notified = []
        out, rep, reads, _ = serve(
            srv, lag, notify_reject=lambda r, e: notified.append(
                (r.rid, e.detail.get("slots"))))
        for r in out:
            if r.status == "done":
                check(list(r.tokens) == clean[r.rid],
                      f"{spec['target']} fault lag {lag}: request {r.rid} "
                      f"stream differs from the clean run")
        events = [(e.step, e.boundary, e.detail.get("slots"),
                   e.detail.get("partial"), e.detail.get("slot_first_bad"))
                  for e in rep.detections]
        print(f"serve {backend} fault {spec['target']}"
              f"{' persistent' if spec.get('persistent') else ''} lag {lag}:"
              f" events {events[:3]}{' ...' if len(events) > 3 else ''} "
              f"({len(events)}), retries {rep.retries}, rollbacks "
              f"{rep.rollbacks}, truncated {rep.truncated_tokens}, rejected "
              f"{rep.rejected}, prefill retries {rep.prefill_retries}, "
              f"completed {len(rep.completed)}; host reads {reads} {since()}",
              flush=True)
        return out, rep, events, notified

    out, rep, events, _ = campaign(slot_fault, 1)
    check(events == [(SERVE_FAULT_TICK, "commit", [1], True, None)]
          and rep.retries >= 1 and rep.rollbacks == 0
          and len(rep.completed) == 8,
          "slot fault at lag 1: not one partial commit and retry")
    out, rep, events, _ = campaign(slot_fault, SERVE_LAG)
    check(len(events) == 1 and events[0][:3] == (SERVE_FAULT_TICK,
                                                 "deferred", [1])
          and events[0][4] == {1: SERVE_FAULT_TICK} and rep.rollbacks == 1
          and sum(1 for r in out if r.truncated_tokens > 0) == 1
          and len(rep.completed) == 8,
          f"slot fault at lag {SERVE_LAG}: not one slot rollback")
    out, rep, events, notified = campaign(dict(slot_fault, persistent=True),
                                          1, max_retries=3)
    check(rep.rejected and not rep.stopped
          and [rid for rid, _ in notified] == rep.rejected
          and all(slots == [1] for _, slots in notified)
          and len(rep.completed) + len(rep.rejected) == 8,
          "stuck slot bit: a request outside slot 1 was rejected, or the "
          "server stopped")
    stuck_rejected = list(rep.rejected)
    out, rep, events, _ = campaign(
        dict(leaf_idx=0, flat_idx=7, bit=BF16_EXP_BIT, step=0, replica=1,
             target="prefill"), 1)
    check(events == [(0, "prefill", [0], None, None)]
          and rep.prefill_retries == 1 and len(rep.completed) == 8,
          "admission fault: pack row 0 not retried and admitted")

    # -- fused: both replicas as the 2N rows of one state, one decode and
    # 2N K1 row calls per tick, one prefill of 2K rows per pack
    fused = make_server(rc, backend="fused", device=dev)
    for lag in (1, SERVE_LAG):
        out, rep, reads, counts = serve(fused, lag)
        check(streams(out) == streams(runs[1][0]),
              f"fused lag {lag} streams differ from sequential lag 1")
        check(not rep.detections and sorted(rep.completed) == list(range(8)),
              f"clean fused lag {lag}: {[str(e) for e in rep.detections]}")
        check(counts["flash_attention"] == cfg.num_layers * rep.prefill_packs,
              f"fused lag {lag}: K2 launched {counts['flash_attention']} for "
              f"{rep.prefill_packs} packs")
        lanes = counts["fingerprint"] - 2 * SERVE_SLOTS * rep.steps
        check(2 * rep.prefill_packs <= lanes <= 2 * 4 * rep.prefill_packs,
              f"fused lag {lag}: K1 launched {counts['fingerprint']} for "
              f"{rep.steps} steps and {rep.prefill_packs} packs")
        if lag == 1:
            check(reads == {"prefill_emit": 2 * rep.prefill_packs,
                            "commit_compare": rep.steps,
                            "token_emit": 2 * rep.steps},
                  f"fused lag 1 host reads {reads}")
        else:
            check(set(reads) == {"prefill_emit", "token_emit"},
                  f"fused lag {lag} host reads {reads}")
        print(f"serve fused lag {lag} on {name}: {rep.steps} steps, "
              f"{rep.prefill_packs} packs, {rep.tokens_per_s:.1f} tokens/s, "
              f"{rep.wall_s / rep.steps * 1e3:.2f} ms/step (wall / steps, "
              f"admission included); streams equal sequential lag 1; "
              f"launches {counts} (K1: {2 * SERVE_SLOTS} per decode step, "
              f"{lanes} lanes; K2: {cfg.num_layers} per pack of 2K rows); "
              f"host reads {reads} {since()}", flush=True)
    out, rep, events, _ = campaign(slot_fault, 1, "fused")
    check(events == [(SERVE_FAULT_TICK, "commit", [1], True, None)]
          and rep.retries >= 1 and rep.rollbacks == 0
          and len(rep.completed) == 8,
          "fused slot fault at lag 1: not one partial commit and retry")
    out, rep, events, _ = campaign(slot_fault, SERVE_LAG, "fused")
    check(len(events) == 1 and events[0][:3] == (SERVE_FAULT_TICK,
                                                 "deferred", [1])
          and events[0][4] == {1: SERVE_FAULT_TICK} and rep.rollbacks == 1
          and len(rep.completed) == 8,
          f"fused slot fault at lag {SERVE_LAG}: not one slot rollback")
    for lag in (1, SERVE_LAG):
        out, rep, events, notified = campaign(
            dict(slot_fault, persistent=True), lag, "fused", max_retries=3)
        check(rep.rejected and not rep.stopped
              and [rid for rid, _ in notified] == rep.rejected
              and all(slots == [1] for _, slots in notified)
              and len(rep.completed) + len(rep.rejected) == 8
              and (lag != 1 or rep.rejected == stuck_rejected),
              f"fused stuck slot bit at lag {lag}: rejections {rep.rejected} "
              f"(sequential lag 1: {stuck_rejected}), or the server stopped")

    # -- abft / hybrid: one packed state, the (N, V) logits through the
    # checksum guard every tick; hybrid's per-slot resident baseline
    from repro_torch.configs import SedarConfig
    interval = 8
    rc_h = RunConfig(model=cfg, sedar=SedarConfig(
        param_validate_interval=interval))
    free = {b: make_server(rc_h, backend=b, device=dev)
            for b in ("abft", "hybrid")}
    for backend, srv in free.items():
        out, rep, reads, counts = serve(srv, 1)
        checks = reads.get("state_validate", 0)
        check(streams(out) == clean,
              f"{backend} serve streams differ from the unprotected run")
        check(not rep.detections and sorted(rep.completed) == list(range(8)),
              f"clean {backend} serve: {[str(e) for e in rep.detections]}")
        want = {"prefill_emit": 2 * rep.prefill_packs,
                "abft_verdict": rep.steps, "token_emit": 2 * rep.steps}
        if backend == "hybrid":
            check(checks > 0, "hybrid serve ran no entry check")
            want["state_validate"] = checks
        check(reads == want, f"{backend} serve host reads {reads}")
        check(counts == {"fingerprint": (0 if backend == "abft"
                                         else rep.steps + checks),
                         "flash_attention": cfg.num_layers
                         * rep.prefill_packs},
              f"{backend} serve launches {counts}")
        print(f"serve {backend} on {name}: {rep.steps} steps, "
              f"{rep.prefill_packs} packs, {rep.tokens_per_s:.1f} tokens/s, "
              f"{rep.wall_s / rep.steps * 1e3:.2f} ms/step; streams equal "
              f"the unprotected run; launches {counts} (K1: one resident "
              f"fingerprint per commit and per entry check for hybrid); "
              f"host reads {reads} {since()}", flush=True)
    V = cfg.vocab_size
    kernel_fault = dict(leaf_idx=0, flat_idx=1 * (V + 1) + 7, bit=30,
                        step=SERVE_FAULT_TICK, replica=0, target="kernel")
    for backend in ("abft", "hybrid"):
        out, rep, _, _ = campaign(kernel_fault, 1, backend, rc_h)
        check([(e.step, e.boundary, e.effect,
                bool(e.detail.get("abft_corrected")))
               for e in rep.detections]
              == [(SERVE_FAULT_TICK, "commit", "TDC", True)]
              and rep.retries == 0 and rep.rollbacks == 0
              and len(rep.completed) == 8,
              f"{backend}: the slot's kernel fault not corrected forward")
    out, rep, _, _ = campaign(
        dict(leaf_idx=0, flat_idx=5, bit=30, step=0, replica=0,
             target="prefill_kernel"), 1, "abft", rc_h)
    check([(e.step, e.boundary, e.effect) for e in rep.detections]
          == [(0, "prefill", "abft_corrected")]
          and rep.prefill_retries == 0 and len(rep.completed) == 8,
          "abft: the admission's kernel fault not corrected at admission")

    # K1's row-limit leaves (hybrid's resident baseline) on the serve cache
    # at mixed positions, against the plain version, bitwise (h1, h2)
    from repro_torch.core.fingerprint import slot_rows_fingerprint
    gen = torch.Generator(device=dev).manual_seed(16)
    shape = (cfg.num_layers, SERVE_SLOTS, SERVE_MAX_LEN, cfg.num_kv_heads,
             cfg.head_dim)
    cache = {n: torch.randn(shape, generator=gen, device=dev).bfloat16()
             for n in "kv"}
    pos = torch.tensor([0, 97, 260, SERVE_MAX_LEN], device=dev)
    tok = torch.arange(SERVE_SLOTS, device=dev)[:, None]
    before = kfp.launch_count.n
    got = slot_rows_fingerprint(cache, pos, tok)
    check(kfp.launch_count.n == before + 1, "K1 row limits: not one launch")
    cpu_cache = {n: c.cpu() for n, c in cache.items()}
    want = slot_rows_fingerprint(cpu_cache, pos.cpu(), tok.cpu())
    check(torch.equal(got[:2].cpu(), want[:2])
          and got[3].item() == want[3].item(),
          f"K1 row-limit leaves differ from the plain version: {got} vs "
          f"{want}")
    lim_ms = device_ms(lambda: slot_rows_fingerprint(cache, pos, tok), 200)
    lim_calls, _, _ = device_launches(
        lambda: slot_rows_fingerprint(cache, pos, tok))
    live = int(pos.clamp(max=SERVE_MAX_LEN).sum())
    lim_bound, lim_by = bound(2 * 2 * cfg.num_layers * live
                              * cfg.num_kv_heads * cfg.head_dim
                              + 8 * SERVE_SLOTS + 16, 0)
    print(f"K1 row-limit leaves on the serve cache (4 slots, pos "
          f"{pos.tolist()}, bf16): h1/h2/absmax bitwise equal to the plain "
          f"version, {lim_calls:g} launch call per call, device "
          f"{lim_ms:.4f} ms, bound {lim_bound:.5f} ms ({lim_by}: the live "
          f"rows read once) {since()}", flush=True)
    # K2 at the fused pack shapes: one prefill of both replicas' copies
    # (2K = 8 rows for a pack of 4)
    for S in (128, 256):
        _, _, _, err, row_err = check_k2(kfa, 8, S, 800 + S,
                                         f"fused pack 2K=8 S={S}")
        print(f"K2 fused pack 2K=8 S={S}: max abs err {err:.3e}, per row's "
              f"largest value {row_err:.3e} vs plain (bf16), two launches "
              f"bitwise equal", flush=True)

    # serve ms/step of every backend over the first SERVE_TURN_STEPS
    # ticks, in turns (ABBA)
    order = [("none", plain, 1), ("lag 1", dual, 1),
             (f"lag {SERVE_LAG}", dual, SERVE_LAG),
             ("fused lag 1", fused, 1),
             (f"fused lag {SERVE_LAG}", fused, SERVE_LAG),
             ("abft", free["abft"], 1), ("hybrid", free["hybrid"], 1)]
    times, tps, reads_by = {}, {}, {}
    for label, srv, lag in order + order[::-1]:
        _, rep, reads, _ = serve(srv, lag, max_steps=SERVE_TURN_STEPS)
        times.setdefault(label, []).append(rep.wall_s / rep.steps * 1e3)
        tps.setdefault(label, []).append(rep.tokens_per_s)
        reads_by[label] = {k: round(v / rep.steps, 2)
                           for k, v in reads.items()}
    print(f"serve ms/step (wall / steps, first {SERVE_TURN_STEPS} ticks) on "
          f"{name}, same call, in turns none, lag 1, lag {SERVE_LAG}, fused "
          f"lag 1, fused lag {SERVE_LAG}, abft, hybrid, then back: "
          + "; ".join(f"{k} {' / '.join(f'{t:.2f}' for t in v)}"
                      for k, v in times.items()) + f" {since()}",
          flush=True)
    print("serve tokens/s in the same turns (tokens of requests completed "
          "within the window): " + "; ".join(
              f"{k} {' / '.join(f'{t:.1f}' for t in v)}"
              for k, v in tps.items()), flush=True)
    print("serve host reads per tick by label (second turn): " + "; ".join(
        f"{k} {v}" for k, v in reads_by.items()), flush=True)

    # where a dual and a fused lag-1 serve's time goes (profiler on)
    for label, srv in (("dual", dual), ("fused", fused)):
        box = {}

        def profiled():
            box["rep"] = srv.serve(params, serve_requests(),
                                   slots=SERVE_SLOTS, validate_lag=1,
                                   max_len=SERVE_MAX_LEN,
                                   max_steps=SERVE_PROFILE_STEPS)[1]

        wall_ms, busy_ms, launches, kern, calls = device_profile(profiled)
        steps = box["rep"].steps
        print(f"profile of a {label} lag-1 serve (its first {steps} decode "
              f"steps, {box['rep'].prefill_packs} packs, profiler on): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernels "
              f"recorded on the device ({launches / steps:.0f} per decode "
              f"step incl. admission), {calls} launch calls by the host "
              f"({calls / steps:.0f} per decode step incl. admission) "
              f"{since()}", flush=True)
        for e in sorted(kern, key=lambda e: -e.count)[:8]:
            print(f"  x{e.count:<7d} {e.self_device_time_total / 1e3:9.3f} "
                  f"ms {e.key[:90]}", flush=True)
    print(f"serve phase took {time.time() - t_phase:.1f} s", flush=True)
    return runs[1][3], {"dual": dual, "clean": clean, "lag1": runs[1]}


def _timed(obj, name: str, out: list) -> None:
    """Wrap obj.name so each call's wall seconds append to `out`."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t = time.time()
        try:
            return fn(*a, **k)
        finally:
            out.append(time.time() - t)

    setattr(obj, name, timed)


def phase_train_app():
    """L1 and L2 on the paper's own test app (paper-testapp, 4 layers, d
    256, f32), with the reference's scenarios
    (tests/test_detection_recovery.py): a grads fault at step 4 stops L1
    there; a params fault at step 4 in an embedding row no token uses is
    invisible to the grads compare, so the L2 checkpoint cut at 6 is dirty
    and Alg. 1 rolls back twice, to 6 then 3, and ends bitwise equal to
    its clean run. (An L2 version holds the full dual state: 11.86 GB at
    qwen2-0.5b's width, and the chain is never pruned.)"""
    from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                     get_config)
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_trainer
    from repro_torch.data import SyntheticLM
    import shutil
    import tempfile

    cfg = get_config("paper-testapp")
    root = tempfile.mkdtemp(prefix="sedar_app_")

    def run(name, level, spec=None, data=None, **kw):
        sedar = dict(level=level, replication="sequential",
                     validate_interval=1, param_validate_interval=4,
                     checkpoint_interval=4, toe_timeout_s=60.0)
        sedar.update(kw)
        rc = RunConfig(model=cfg, train=TrainConfig(
            global_batch=4, seq_len=16, steps=10, warmup_steps=2, lr=1e-3),
            sedar=SedarConfig(**sedar))
        tr = make_trainer(rc, os.path.join(root, name), inj_spec=spec,
                          data=data, notify=lambda e: None, device="cuda")
        return tr.run(10, dual=tr.engine.executor.init_dual(state))[1]

    try:
        state = make_trainer(
            RunConfig(model=cfg, sedar=SedarConfig(level=1)),
            os.path.join(root, "init"), device="cuda").init_state(seed=0)
        l1 = run("l1", 1, InjectionSpec(leaf_idx=3, flat_idx=5, bit=20,
                                        step=4, replica=1, target="grads"))
        ev1 = [(e.step, e.boundary, e.effect) for e in l1.detections]
        print(f"paper-testapp L1: events {ev1}, stopped {l1.stopped} at "
              f"step {l1.steps_completed}", flush=True)
        check(l1.stopped and ev1 == [(4, "commit", "TDC")]
              and l1.steps_completed == 4, "paper-testapp L1 did not stop "
              "at step 4")
        data = SyntheticLM(200, 4, 16, seed=0)
        clean = run("clean", 1, data=data)
        check(not clean.detections, "paper-testapp clean run detected")
        l2 = run("l2", 2, InjectionSpec(
            leaf_idx=1, flat_idx=250 * cfg.d_model + 3, bit=22, step=4,
            replica=1, target="params"), data=data, checkpoint_interval=3,
            param_validate_interval=8)
        ev2 = [(e.step, e.boundary, e.effect) for e in l2.detections]
        rec2 = [(r["kind"], r["step"], r["rollbacks"])
                for r in l2.recoveries]
        same = np.array_equal(l2.final_state_fp[:, :2],
                              clean.final_state_fp[:, :2])
        print(f"paper-testapp L2 dirty checkpoint: events {ev2}, recoveries "
              f"{rec2}, checkpoints {l2.checkpoints}, final fingerprints "
              f"bitwise equal to the clean run: {same}", flush=True)
        check(ev2 == [(8, "validate", "FSC"), (8, "validate", "FSC")]
              and rec2 == [("restore", 6, 1), ("restore", 3, 2)]
              and same and l2.steps_completed == 10,
              "paper-testapp L2 did not roll back twice to a clean end")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train(kfp):
    """Slice 4: protected training of qwen2-0.5b at full width and depth
    (f32 masters, bf16 compute, seeded weights, adamw), global batch 4 x
    256 tokens from SyntheticLM(seed 0), 6 steps, L3 with the sequential
    backend (commit compare every step, FSC compare and validated
    checkpoint every 2). A clean run, a grads fault at step 3 that must
    restore from step 2 and end bitwise equal to the clean run, runs under
    none and under sequential without checkpoints for ms/step, the host
    launch calls of one protected step, and K1 on the full grads and
    params+opt trees against its plain version. Returns K1's launches in
    the clean run."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                     get_config)
    from repro_torch.core import hostsync
    from repro_torch.core.fingerprint import pytree_fingerprint_fused
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_trainer
    from repro_torch.data import SyntheticLM
    from repro_torch.tree import leaves

    t_phase = time.time()
    _free()

    def since() -> str:
        return f"[train phase +{time.time() - t_phase:.1f} s]"

    dev = torch.device("cuda")
    cfg = get_config("qwen2-0.5b")
    data = SyntheticLM(cfg.vocab_size, BATCH, TRAIN_SEQ, seed=0)
    l3 = SedarConfig(level=3, replication="sequential", validate_interval=1,
                     param_validate_interval=2, checkpoint_interval=2)
    root = tempfile.mkdtemp(prefix="sedar_train_")

    def trainer(name, sedar, spec=None):
        rc = RunConfig(model=cfg, train=TrainConfig(
            global_batch=BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
            warmup_steps=2), sedar=sedar)
        return make_trainer(rc, os.path.join(root, name), inj_spec=spec,
                            data=data, notify=lambda e: None, device=dev)

    def ms_step(rep) -> float:
        return rep.wall_s * 1e3 / max(rep.steps_completed, 1)

    try:
        tr = trainer("clean", l3)
        t0 = time.time()
        state = tr.init_state(seed=0)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in leaves(state["params"]))
        n_words = n_params * 3
        print(f"train phase: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
              f"V={cfg.vocab_size}, {n_params} f32 params ({n_words} words "
              f"of params + adamw m, v; seeded init {time.time() - t0:.2f} "
              f"s), bf16 compute, batch {BATCH} x {TRAIN_SEQ} tokens, "
              f"{TRAIN_STEPS} steps, L3 sequential (FSC and checkpoint "
              f"every 2), workdir {root}", flush=True)
        none = trainer("none", SedarConfig(level=1, replication="none"))
        plain = {b: trainer(b, dataclasses.replace(
            l3, level=1, checkpoint_interval=0, replication=b))
            for b in TRAIN_BACKENDS[1:]}
        seq = plain["sequential"]
        turn_order = [("none", none)] + list(plain.items())
        turns = {name: [] for name, _ in turn_order}
        for name, t in turn_order:
            t.run(1, dual=t.engine.executor.init_dual(state))    # warm-up
            r = t.run(TRAIN_STEPS, dual=t.engine.executor.init_dual(state))[1]
            check(not r.detections and r.steps_completed == TRAIN_STEPS,
                  f"{name} training run: {r.summary()}")
            turns[name].append(ms_step(r))

        ck_s: list = []
        _timed(tr.recovery, "maybe_checkpoint", ck_s)
        kfp.launch_count.reset()
        torch.cuda.reset_peak_memory_stats()
        with hostsync.count_transfers() as st:
            dual, rep = tr.run(TRAIN_STEPS,
                               dual=tr.engine.executor.init_dual(state))
        k1_launches = kfp.launch_count.n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        store = tr.recovery.store
        names = sorted(os.listdir(store.dir))
        man = store.manifest(TRAIN_STEPS)
        print(f"{since()} L3 clean run: {rep.summary()}; losses "
              f"{rep.losses}; checkpoints {rep.checkpoints}, on disk "
              f"{names}; K1 launches {k1_launches} "
              f"({k1_launches / TRAIN_STEPS:.1f} per step); host reads "
              f"{st.by_label}; peak memory {peak:.2f} GiB", flush=True)
        check(not rep.detections and not rep.stopped,
              f"clean training run detected {[str(e) for e in rep.detections]}")
        check(rep.checkpoints == [2, 4, 6], f"checkpoints {rep.checkpoints}")
        check(names == [f"ckpt_{TRAIN_STEPS:08d}"],
              f"L3 must leave exactly one checkpoint and no .tmp: {names}")
        check(man.valid is True and man.kind == "app" and man.n_leaves ==
              3 * len(leaves(state["params"])) + 1, f"manifest {man}")
        check(len(rep.losses) == TRAIN_STEPS
              and all(np.isfinite(rep.losses)), f"losses {rep.losses}")
        # every fingerprint of the run goes through K1: 2 per step on the
        # grads, 2 per FSC, per checkpoint one per state leaf (manifest) and
        # one per stored leaf (digests, + the step counter), and one per
        # state leaf for the final fingerprint
        n_fp = 3 * len(leaves(state["params"]))
        want_k1 = (2 * TRAIN_STEPS
                   + 2 * (TRAIN_STEPS // l3.param_validate_interval)
                   + (TRAIN_STEPS // l3.checkpoint_interval) * (2 * n_fp + 1)
                   + n_fp)
        check(k1_launches == want_k1,
              f"K1 launched {k1_launches} times, not {want_k1}: a "
              f"fingerprint of the training path left the kernel")
        ck_gb = man.bytes_on_disk / 1e9
        print(f"L3 checkpoint: {man.bytes_on_disk} bytes on disk "
              f"({ck_gb:.3f} GB), seconds per checkpoint (save + fsync + "
              f"delete of the previous) {[round(x, 3) for x in ck_s]}",
              flush=True)

        spec = InjectionSpec(target="grads", leaf_idx=0, flat_idx=5, bit=20,
                             step=3, replica=1)
        ftr = trainer("fault", l3, spec)
        fck_s: list = []
        _timed(ftr.recovery, "restore", fck_s)
        frep = ftr.run(TRAIN_STEPS,
                       dual=ftr.engine.executor.init_dual(state))[1]
        events = [(e.step, e.boundary, e.effect) for e in frep.detections]
        recs = [(r["kind"], r["step"], r["rollbacks"])
                for r in frep.recoveries]
        same_fp = np.array_equal(frep.final_state_fp[:, :2],
                                 rep.final_state_fp[:, :2])
        print(f"{since()} L3 fault run (grads leaf 0 element 5 bit 20, "
              f"replica 1, step 3): events {events}, recoveries "
              f"{frep.recoveries}, restore {[round(x, 3) for x in fck_s]} s;"
              f" final per-leaf fingerprints bitwise equal to the clean "
              f"run: {same_fp}, losses equal: {frep.losses == rep.losses}",
              flush=True)
        check(events == [(3, "commit", "TDC")], f"fault events {events}")
        check(recs == [("restore", 2, 1)], f"fault recoveries {recs}")
        check(same_fp and frep.losses == rep.losses
              and frep.steps_completed == TRAIN_STEPS,
              "the recovered run does not end bitwise equal to the clean run")

        _, grads = tr.loss_and_grads(state["params"], tr.batch(0))
        opt_tree = {"params": tr.engine.executor.primary(dual)["params"],
                    "opt": tr.engine.executor.primary(dual)["opt"]}
        # times by CUDA events per call (a launch of 0.7-2 ms dwarfs the
        # host's gap); one launch per call by the host's launch calls: the
        # profiler's device records of this torch build can miss every K1
        # record in a window (seen after the serve phase)
        for what, tree in (("the full-width grads", grads),
                           ("params + adamw m, v after 6 steps", opt_tree)):
            ds, rows, n = k1_tree_values(kfp, tree, what)
            calls, ran, _ = device_launches(
                lambda: pytree_fingerprint_fused(tree))
            check(calls == 1 and ran <= 1,
                  f"K1 on {what}: {calls} launch calls and {ran} device "
                  f"kernels per call")
            table = kfp.leaf_table(leaves(tree))
            ms = cuda_ms(lambda: pytree_fingerprint_fused(tree), 20)
            plain_ms = cuda_ms(lambda: kfp.fingerprint_leaves_plain(table),
                               2, warmup=1)
            b_ms, b_by = bound(4 * n + 16, 0)
            print(f"K1 in place on {what}: {rows} leaves, {n} words, "
                  f"h1/h2/absmax bitwise equal to pack + plain and to the "
                  f"plain leaf walk, |ds|={ds:.3e}, {calls:g} launch call "
                  f"and {ran:g} device kernel records per call; per call "
                  f"{ms:.4f} ms ({4 * n / ms / 1e9:.3f} TB/s), plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
        # the L3 run's dual state goes before the fused runs (~59 GiB)
        del dual, grads, opt_tree, tr, ftr
        _free()

        for name, t in reversed(turn_order):
            t.run(1, dual=t.engine.executor.init_dual(state))    # warm-up
            r = t.run(TRAIN_STEPS, dual=t.engine.executor.init_dual(state))[1]
            check(not r.detections, f"{name} training run: {r.summary()}")
            turns[name].append(ms_step(r))
        print(f"training ms/step (wall / steps, {BATCH} x {TRAIN_SEQ} "
              f"tokens, each run after a 1-step warm-up; two turns each, in "
              f"the order "
              f"{', '.join(turns)} and back): "
              + ", ".join(f"{k} {[round(v, 2) for v in ms]}"
                          for k, ms in turns.items())
              + f"; sequential + L3 (3 checkpoints) {ms_step(rep):.2f} and "
              f"with the fault's restore {ms_step(frep):.2f}", flush=True)

        batch = seq.batch(2)
        for name, t in (("sequential", seq), ("none", none),
                        ("fused", plain["fused"])):
            d = t.engine.executor.init_dual(state)
            t.engine.run_protected_step(d, (2, batch), 2)      # warm
            wall_ms, busy_ms, ran, kern, calls = device_profile(
                lambda: t.engine.run_protected_step(d, (2, batch), 2))
            print(f"one {name} training step (no boundary, profiler on): "
                  f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
                  f"({100 * busy_ms / wall_ms:.1f}%), {calls} host launch "
                  f"calls, {ran} device kernels", flush=True)
            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}%"
                      f" x{e.count:<6d} {e.key[:90]}", flush=True)
            del d

        # the new phases rebuild the seeded initial state for each run
        # (0.01-0.3 s on the card) rather than hold 5.93 GB beside a fused
        # step
        init = none
        del plain, seq, none, turn_order, t, state
        _free()

        def make_state():
            return init.init_state(seed=0)

        k1_launches += phase_train_backends(kfp, trainer, make_state, rep,
                                            l3)
        print(f"{since()} train backends done", flush=True)
        k1_launches += phase_train_tiers(kfp, trainer, make_state,
                                         rep.losses, l3, spec)
        print(f"{since()} train tiers done", flush=True)
        k1_launches += phase_telemetry_train(kfp, trainer, make_state, l3)
        print(f"{since()} train telemetry done", flush=True)
        del init
        _free()
        phase_train_app()
        phase_tiers_app()
        print(f"train phase took {time.time() - t_phase:.1f} s", flush=True)
        return k1_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _free() -> None:
    """Collect dropped trainers (a trainer and its engine refer to each
    other) so their states go back to the allocator's cache: a full-width
    fused step needs ~60 GiB. The cache is kept: with expandable segments
    an emptied cache is mapped again by the next large step, which the
    step's time would then include."""
    import gc
    gc.collect()


def _timed_sync(obj, name: str, out: list) -> None:
    """`_timed` with the card synchronized before and after each call, so a
    device copy's time is in the wall seconds."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.time()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            out.append(time.time() - t)

    setattr(obj, name, timed)


# fused against sequential on the card (qwen2-0.5b, 6 steps of 4 x 256
# tokens): the replica-batched products round otherwise, so no grads leaf is
# bitwise equal. Limits: about twice the larger of fused's gap and the
# control's (the unbatched step on the same sequences in reverse order), as
# read on an NVIDIA H100 80GB HBM3 at 700.00 W: losses 7.134e-5 (control
# 5.610e-5) relative, step-0 grads 1.994e-2 (control 4.219e-3) of a leaf's
# max |g|
FUSED_LOSS_RTOL = 1.5e-4
FUSED_GRAD_GAP = 4e-2


def _reversed(batch: dict) -> dict:
    """The same batch with its sequences in reverse order: the same loss,
    summed in another order."""
    return {k: v.flip(0) for k, v in batch.items()}


def _l3_k1_launches(backend: str, n_fp: int, sedar) -> int:
    """K1's launches in a clean 6-step L3 run on the device tier, as the
    code gives them: per checkpoint one per state leaf (the validated
    state's per-leaf fingerprint; the device ring stores no digests) and
    one per state leaf for the final fingerprint. fused: 2 per step on its
    two grads views and 2 per FSC compare (one per replica's view).
    hybrid: 1 per commit (the resident baseline), 1 per entry check (steps
    2 and 4), 1 per checkpoint (its "equal") and 1 for the final
    validation. abft: nothing more (its training step is uninstrumented)."""
    ckpts = TRAIN_STEPS // sedar.checkpoint_interval
    per_ckpt = n_fp
    if backend == "fused":
        return (2 * TRAIN_STEPS
                + 2 * (TRAIN_STEPS // sedar.param_validate_interval)
                + ckpts * per_ckpt + n_fp)
    if backend == "abft":
        return ckpts * per_ckpt + n_fp
    entries = len([s for s in range(1, TRAIN_STEPS)
                   if s % sedar.param_validate_interval == 0])
    return TRAIN_STEPS + entries + ckpts * (per_ckpt + 1) + 1 + n_fp


def phase_train_backends(kfp, trainer, make_state, clean, l3) -> int:
    """Slice 5: fused, abft and hybrid training of the same full-width
    qwen2-0.5b under L3 (the sequential run's TrainConfig and data), the
    validated checkpoint kept in the device tier: a call on the card may
    write 45 GiB to its disk, and the sequential L3 runs above write
    35.6 GB. Clean runs of each give 0 detections (fused's peak memory and
    K1's launches checked against the code's count); fused's grads fault
    (leaf 0 element 5 bit 20, replica 1, step 3) is detected at the
    commit, restored from step 2 and ends bitwise equal to fused's clean
    run; one resident parameter bit flipped in place between steps 3 and
    4 is caught by hybrid's entry check at step 4 (FSC), restored, and the
    run ends bitwise equal to hybrid's clean run, while pure abft misses
    the same fault. K1 on the two views of the stacked grads against its
    plain version. Fused against sequential: bits differ (a replica-batched
    product rounds otherwise), so its losses and its step-0 grads are held
    to FUSED_LOSS_RTOL and FUSED_GRAD_GAP, printed beside a control, the
    unbatched step on the same sequences in reverse order. Returns K1's
    launches in the three clean runs."""
    import dataclasses

    from repro_torch.configs import SedarConfig
    from repro_torch.core.engine import replica_view
    from repro_torch.core.fingerprint import pytree_fingerprint_fused
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.tree import leaves

    n_fp = 3 * len(leaves(make_state()["params"]))
    launches = 0
    reps = {}
    l3 = dataclasses.replace(l3, ckpt_tiers="device")
    ring_s: dict = {}
    for backend in ("fused", "abft", "hybrid"):
        sedar = dataclasses.replace(l3, replication=backend)
        tr = trainer(f"{backend}_clean", sedar)
        _timed_sync(tr.recovery.tiers.device, "save",
                    ring_s.setdefault(backend, []))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kfp.launch_count.reset()
        r = tr.run(TRAIN_STEPS, dual=tr.engine.executor.init_dual(make_state()))[1]
        n = kfp.launch_count.n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        same = (np.array_equal(r.final_state_fp[:, :2],
                               clean.final_state_fp[:, :2])
                and r.losses == clean.losses)
        dl = max(abs(a - b) for a, b in zip(r.losses, clean.losses))
        rl = max(abs(a - b) / abs(b) for a, b in zip(r.losses, clean.losses))
        print(f"{backend} L3 clean run: {r.summary()}; losses {r.losses}; "
              f"checkpoints {r.checkpoints}; K1 launches {n}; peak memory "
              f"{peak:.2f} GiB; final per-leaf fingerprints and losses "
              f"bitwise equal to sequential's: {same} (max |dloss| "
              f"{dl:.3e}, relative {rl:.3e})", flush=True)
        check(not r.detections and not r.stopped
              and r.steps_completed == TRAIN_STEPS
              and r.checkpoints == [2, 4, 6]
              and all(np.isfinite(r.losses)),
              f"clean {backend} training run: {r.summary()}")
        if backend in ("abft", "hybrid"):
            # one instance of the very step sequential's replica 0 runs
            check(same, f"{backend} training is not bitwise equal to "
                  "sequential's replica 0")
        else:
            check(rl <= FUSED_LOSS_RTOL, f"fused losses {rl:.3e} (relative) "
                  f"from sequential's, limit {FUSED_LOSS_RTOL:g}")
        want = _l3_k1_launches(backend, n_fp, l3)
        check(n == want, f"{backend}: K1 launched {n} times, not {want}")
        launches += n
        reps[backend] = r
        del tr
        _free()
    print("device-tier saves of the validated 5.93 GB state (s): " + "; ".join(
        f"{b} {[round(x, 4) for x in v]}" for b, v in ring_s.items()),
        flush=True)

    spec = InjectionSpec(target="grads", leaf_idx=0, flat_idx=5, bit=20,
                         step=3, replica=1)
    ftr = trainer("fused_fault", dataclasses.replace(l3, replication="fused"),
                  spec)
    frep = ftr.run(TRAIN_STEPS, dual=ftr.engine.executor.init_dual(make_state()))[1]
    events = [(e.step, e.boundary, e.effect) for e in frep.detections]
    recs = [(r["kind"], r["step"], r["rollbacks"]) for r in frep.recoveries]
    same = (np.array_equal(frep.final_state_fp[:, :2],
                           reps["fused"].final_state_fp[:, :2])
            and frep.losses == reps["fused"].losses)
    print(f"fused L3 fault run (grads leaf 0 element 5 bit 20, replica 1, "
          f"step 3): events {events}, recoveries {frep.recoveries}; final "
          f"per-leaf fingerprints and losses bitwise equal to fused's clean "
          f"run: {same}", flush=True)
    check(events == [(3, "commit", "TDC")] and recs == [("restore", 2, 1)]
          and same and frep.steps_completed == TRAIN_STEPS,
          "fused: the grads fault was not recovered to the clean run")

    del ftr
    _free()

    # K1 on both replicas' views of one stacked grads tree, and the fused
    # grads against one replica's (the sequential backend's) at step 0
    fz = trainer("fused_grads", dataclasses.replace(l3, replication="fused"))
    d = fz.engine.executor.init_dual(make_state())
    batch = fz.batch(0)
    _, grads = fz.loss_and_grads_stacked(d["s"]["params"], batch)
    del d
    views = [_k1_words(pytree_fingerprint_fused(replica_view(grads, r)))
             for r in range(2)]
    for r in range(2):
        k1_tree_values(kfp, replica_view(grads, r),
                       f"replica {r}'s view of the stacked grads")
    eq = all(torch.equal(a, b) for a, b in zip(
        leaves(replica_view(grads, 0)), leaves(replica_view(grads, 1))))
    params = make_state()["params"]
    _, single = fz.loss_and_grads(params, batch)
    _, ctl = fz.loss_and_grads(params, _reversed(batch))
    del params

    def gap(tree):
        """(leaves bitwise equal to `single`'s, the largest per-leaf
        max |diff| / max |g|, that leaf's index)."""
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(leaves(tree), leaves(single))]
        i = int(np.argmax(rel))
        return sum(r == 0 for r in rel), rel[i], i

    n_same, worst, wi = gap(replica_view(grads, 0))
    c_same, c_worst, ci = gap(ctl)
    print(f"fused full-width grads: the two replicas' slices bitwise equal "
          f"{eq}; K1 on each view (one launch each, in place) bitwise equal "
          f"to pack + plain and to each other: "
          f"{np.array_equal(views[0], views[1])}; against one replica's "
          f"unbatched grads: {n_same} of {len(leaves(single))} leaves "
          f"bitwise equal, largest |diff| / max|g| of a leaf {worst:.3e} "
          f"(leaf {wi}; limit {FUSED_GRAD_GAP:g}); control, the unbatched "
          f"step on the sequences in reverse order: {c_same} bitwise equal, "
          f"{c_worst:.3e} (leaf {ci})", flush=True)
    check(eq and np.array_equal(views[0], views[1]),
          "fused: the replicas' grads differ")
    check(worst <= FUSED_GRAD_GAP, f"fused grads {worst:.3e} of a leaf's "
          f"max |g| from the unbatched step's, limit {FUSED_GRAD_GAP:g}")
    del grads, single, ctl
    # the FSC compare's call: replica 1's view of the stacked params and
    # adamw moments (42 leaves at an offset into each stacked tensor)
    d = fz.engine.executor.init_dual(make_state())
    k1_tree_values(kfp, replica_view({"params": d["s"]["params"],
                                      "opt": d["s"]["opt"]}, 1),
                   "replica 1's view of the stacked params + adamw m, v")
    print("K1 in place on replica 1's view of the stacked params + adamw "
          "m, v: h1/h2/absmax bitwise equal to pack + plain and to the "
          "plain leaf walk", flush=True)
    del d, fz
    _free()

    # the loss control: the unbatched step's 6 steps on every batch's
    # sequences in reverse order, against sequential's clean run
    ctr = trainer("order_control", SedarConfig(level=1, replication="none"))
    ordered = ctr.batch
    ctr.batch = lambda step: _reversed(ordered(step))
    closses = ctr.run(TRAIN_STEPS,
                      dual=ctr.engine.executor.init_dual(make_state()))[1].losses
    crl = max(abs(a - b) / abs(b) for a, b in zip(closses, clean.losses))
    print(f"loss control, the unbatched step on reversed sequences: losses "
          f"{closses}, relative to sequential's {crl:.3e} (fused's limit "
          f"{FUSED_LOSS_RTOL:g})", flush=True)
    del ctr
    _free()

    # an at-rest fault: one resident parameter bit between steps 3 and 4
    rest = {}
    for backend in ("hybrid", "abft"):
        tr = trainer(f"{backend}_rest",
                     dataclasses.replace(l3, replication=backend))
        d, r1 = tr.run(4, dual=tr.engine.executor.init_dual(make_state()))
        tok = tr.engine.executor.primary(d)["params"]["embed"]["tok"]
        tok.view(-1)[5:6].view(torch.int32).bitwise_xor_(1 << 20)
        r2 = tr.run(TRAIN_STEPS, dual=d)[1]
        rest[backend] = (r2, r1.losses + r2.losses)
        del d, tr
        _free()
    hr, hlosses = rest["hybrid"]
    events = [(e.step, e.boundary, e.effect) for e in hr.detections]
    recs = [(r["kind"], r["step"], r["rollbacks"]) for r in hr.recoveries]
    same = (np.array_equal(hr.final_state_fp[:, :2],
                           reps["hybrid"].final_state_fp[:, :2])
            and hlosses == reps["hybrid"].losses)
    print(f"hybrid L3, embed.tok element 5 bit 20 flipped at rest after step "
          f"4's commit: events {events}, recoveries {hr.recoveries}; final "
          f"fingerprints and losses bitwise equal to hybrid's clean run: "
          f"{same}", flush=True)
    check(events == [(4, "validate", "FSC")] and recs == [("restore", 4, 1)]
          and same, "hybrid did not catch and recover the at-rest fault")
    ar, alosses = rest["abft"]
    missed = not np.array_equal(ar.final_state_fp[:, :2],
                                reps["abft"].final_state_fp[:, :2])
    print(f"pure abft, the same at-rest fault: detections "
          f"{len(ar.detections)}, final state differs from abft's clean run: "
          f"{missed} (the reference's abft misses it too)", flush=True)
    check(not ar.detections and missed,
          "pure abft: the at-rest fault should go undetected")
    return launches


TIER_STEPS = 3    # one checkpoint, at 2: one 5.93 GB write to the disk
TIER_FAULT_STEP = 2


def phase_train_tiers(kfp, trainer, make_state, clean_l3_losses, l3,
                      spec) -> int:
    """L3 sequential with `ckpt_tiers="device,host,disk"`: the validated
    state goes to all three tiers at the checkpoint of step 2; the grads
    fault (the phase's spec, at step 2) restores from the device tier with
    0 disk reads and 0 host reads during the restore and ends bitwise
    equal to a clean run of the same steps (no checkpoint: it does not
    change the state) and to the L3 clean run's losses. Three steps, so
    one checkpoint is written to the disk (the card's 45 GiB write limit
    per call). Prints the seconds of each tier's save and of the restore.
    Returns K1's launches in the run."""
    import dataclasses

    from repro_torch.checkpoint import count_disk_reads
    from repro_torch.checkpoint import tiers as tiers_mod
    from repro_torch.core import hostsync

    plain = trainer("tiers_clean", dataclasses.replace(
        l3, level=1, checkpoint_interval=0))
    clean = plain.run(TIER_STEPS,
                      dual=plain.engine.executor.init_dual(make_state()))[1]
    check(clean.losses == clean_l3_losses[:TIER_STEPS],
          "a clean run without checkpoints left the L3 run's trajectory")
    del plain
    _free()
    sedar = dataclasses.replace(l3, ckpt_tiers="device,host,disk")
    tr = trainer("tiers_fault", sedar,
                 dataclasses.replace(spec, step=TIER_FAULT_STEP))
    tiers = tr.recovery.tiers
    secs = {"device": [], "host copy": [], "disk": [], "restore": []}
    _timed_sync(tiers.device, "save", secs["device"])
    _timed_sync(tiers.disk, "save", secs["disk"])
    snap = tiers_mod.snapshot
    counted = {}
    orig_restore = tr.recovery.restore

    def timed_snapshot(state_):
        torch.cuda.synchronize()
        t = time.time()
        out = snap(state_)
        secs["host copy"].append(time.time() - t)
        return out

    def restore(action, template):
        torch.cuda.synchronize()
        with count_disk_reads() as dr, hostsync.count_transfers() as ht:
            t = time.time()
            out = orig_restore(action, template)
            torch.cuda.synchronize()
            secs["restore"].append(time.time() - t)
        counted.update(disk_reads=dr.reads, host_reads=ht.transfers)
        return out

    tr.recovery.restore = restore
    tiers_mod.snapshot = timed_snapshot
    kfp.launch_count.reset()
    try:
        rep = tr.run(TIER_STEPS, dual=tr.engine.executor.init_dual(make_state()))[1]
    finally:
        tiers_mod.snapshot = snap
    n = kfp.launch_count.n
    del tr
    _free()
    events = [(e.step, e.boundary, e.effect) for e in rep.detections]
    rec = rep.recoveries[0] if rep.recoveries else {}
    same = (np.array_equal(rep.final_state_fp[:, :2],
                           clean.final_state_fp[:, :2])
            and rep.losses == clean.losses)
    print(f"tiered L3 (device,host,disk) fault run, {TIER_STEPS} steps: "
          f"events {events}, "
          f"recoveries {rep.recoveries}; during the restore {counted}; saves "
          f"by tier {tiers.saves_by_tier}, left in the tiers: device "
          f"{tiers.device.versions()}, host {tiers.host.versions()}, disk "
          f"{tiers.disk.steps()}; final fingerprints and losses bitwise "
          f"equal to the clean run: {same}; K1 launches {n}", flush=True)
    print("tier seconds per save of the 5.93 GB validated state, and "
          "of the restore: " + "; ".join(
        f"{k} {[round(x, 4) for x in v]}" for k, v in secs.items())
        + " (the flat-disk restore took 3.4-3.8 s on this card before, "
        "PERF.md)", flush=True)
    check(events == [(TIER_FAULT_STEP, "commit", "TDC")]
          and rec.get("tier") == "device"
          and (rec.get("kind"), rec.get("step"), rec.get("version"))
          == ("restore", 2, 2), f"tiered L3 recovery {rep.recoveries}")
    check(counted == {"disk_reads": 0, "host_reads": 0},
          f"the device-tier restore read the disk or the host: {counted}")
    check(same and rep.checkpoints == [2],
          "tiered L3: the recovered run is not the clean run")
    check(tiers.device.versions() == [2] and tiers.host.versions() == [2]
          and tiers.disk.steps() == [2], "L3 keeps one version per tier")
    return n


def _flip_leaf_byte(store_dir: str, step: int, leaf: int = 0) -> None:
    path = os.path.join(store_dir, f"ckpt_{step:08d}", f"leaf_{leaf:05d}.npy")
    arr = np.load(path)
    arr.reshape(-1).view(np.uint8)[3] ^= 0x10
    np.save(path, arr)


def phase_tiers_app():
    """The tier hierarchy under L2 on paper-testapp, the reference's
    tests/test_tiers.py scenarios: a grads fault restored from the device
    ring with 0 disk reads and 0 host reads; a 1-slot ring at a sparse
    cadence that does not hold the target, so the disk serves it; Alg. 1
    walking the union of the tiers' versions newest first; a corrupted
    disk version served by the partner, then (partner corrupted too) an
    older host-ring version, each fallback a recorded event. Every
    recovered run ends bitwise equal to its flat-disk clean run."""
    from repro_torch.checkpoint import (CheckpointStore, TieredCheckpointer,
                                        TierSchedule, count_disk_reads)
    from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                     get_config)
    from repro_torch.core import hostsync
    from repro_torch.core.detection import DetectionEvent
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_trainer
    from repro_torch.tree import leaves
    import shutil
    import tempfile

    cfg = get_config("paper-testapp")
    root = tempfile.mkdtemp(prefix="sedar_tiers_")

    def trainer(name, spec=None, **kw):
        sedar = dict(level=2, replication="sequential", validate_interval=1,
                     param_validate_interval=0, checkpoint_interval=3,
                     toe_timeout_s=60.0, ckpt_tiers="device,host,disk")
        sedar.update(kw)
        rc = RunConfig(model=cfg, train=TrainConfig(
            global_batch=4, seq_len=16, steps=10, warmup_steps=2, lr=1e-3),
            sedar=SedarConfig(**sedar))
        return make_trainer(rc, os.path.join(root, name), inj_spec=spec,
                            notify=lambda e: None, device="cuda")

    def counted_run(tr, steps):
        got = {}
        orig = tr.engine.on_detection

        def on_detection(event, dual):
            with count_disk_reads() as dr, hostsync.count_transfers() as ht:
                out = orig(event, dual)
            got.setdefault("disk_reads", []).append(dr.reads)
            got.setdefault("host_reads", []).append(ht.transfers)
            return out

        tr.engine.on_detection = on_detection
        return tr.run(steps, dual=tr.engine.executor.init_dual(state)), got

    def same(a, b) -> bool:
        return np.array_equal(a.final_state_fp[:, :2], b.final_state_fp[:, :2])

    try:
        state = trainer("init").init_state(seed=0)
        fault = InjectionSpec(leaf_idx=3, flat_idx=5, bit=20, step=4,
                              replica=1, target="grads")
        flat = trainer("clean", ckpt_tiers="disk")
        clean = flat.run(10, dual=flat.engine.executor.init_dual(state))[1]
        (_, ring), got = counted_run(trainer("ring", fault), 10)
        r = ring.recoveries[0]
        print(f"paper-testapp L2 device,host,disk: events "
              f"{[(e.step, e.boundary, e.effect) for e in ring.detections]},"
              f" recovery {r}, reads during the restore {got}, bitwise equal"
              f" to the flat-disk clean run: {same(ring, clean)}", flush=True)
        check(r["tier"] == "device" and r["step"] == 4
              and got == {"disk_reads": [0], "host_reads": [0]}
              and same(ring, clean), "L2 ring restore")

        late = InjectionSpec(leaf_idx=3, flat_idx=5, bit=20, step=7,
                             replica=1, target="grads")
        (_, short), got = counted_run(trainer(
            "short", late, ckpt_tiers="device,disk", checkpoint_interval=2,
            device_ckpt_interval=5, device_ring_slots=1), 10)
        r = short.recoveries[0]
        print(f"paper-testapp L2, 1-slot ring every 5 steps, disk every 2, "
              f"fault at step 7: recovery {r}, reads {got}, bitwise equal to"
              f" the clean run: {same(short, clean)}", flush=True)
        check(r["tier"] == "disk" and r["step"] == 6
              and got["disk_reads"][0] > 0 and same(short, clean),
              "L2 short ring: the disk should serve version 6")

        walk = trainer("walk", device_ring_slots=4)
        dual, _ = walk.run(8, dual=walk.engine.executor.init_dual(state))
        tiers = walk.recovery.tiers
        held = (tiers.device.versions(), tiers.host.versions(),
                tiers.disk.steps())
        ev = DetectionEvent(step=7, boundary="validate", effect="FSC")
        for _ in range(3):
            dual = walk.engine.on_detection(ev, dual)
        got = [(r["step"], r["tier"]) for r in walk.engine.recoveries]
        print(f"paper-testapp L2 walk over device {held[0]}, host {held[1]},"
              f" disk {held[2]}: three detections at step 7 restore "
              f"{got}", flush=True)
        check(held == ([5, 6, 7, 8], [3, 6], [3, 6])
              and got == [(7, "device"), (6, "device"), (5, "device")],
              "Alg. 1 over the tiers' union")
        del dual

        events = []
        tc = TieredCheckpointer(
            TierSchedule(host=2, disk=4, partner=4), host_slots=2,
            disk_store=CheckpointStore(os.path.join(root, "disk")),
            partner_store=CheckpointStore(os.path.join(root, "partner")),
            notify=events.append)
        states = {2: state, 4: trainer("init4").init_state(seed=4)}
        tc.save(2, states[2], async_=False)
        tc.save(4, states[4], async_=False)
        tc.host.keep_only(2)
        _flip_leaf_byte(os.path.join(root, "disk"), 4)
        s1, info1 = tc.restore(4, states[4])
        _flip_leaf_byte(os.path.join(root, "partner"), 4)
        s2, info2 = tc.restore(4, states[4])
        ok1 = all(torch.equal(a, b) for a, b in zip(leaves(s1),
                                                    leaves(states[4])))
        ok2 = all(torch.equal(a, b) for a, b in zip(leaves(s2),
                                                    leaves(states[2])))
        print(f"corrupt disk: served by {info1['tier']} v{info1['version']} "
              f"after {[f['tier'] for f in info1['fallbacks']]}; partner "
              f"corrupt too: {info2['tier']} v{info2['version']} after "
              f"{[f['tier'] for f in info2['fallbacks']]}; states equal to "
              f"the saved ones {ok1}, {ok2}; {len(events)} fallback events",
              flush=True)
        check((info1["tier"], info1["version"]) == ("partner", 4)
              and (info2["tier"], info2["version"]) == ("host", 2)
              and [f["tier"] for f in info2["fallbacks"]]
              == ["disk", "partner"] and ok1 and ok2 and len(events) == 3,
              "tier fallback disk -> partner -> host")
    finally:
        shutil.rmtree(root, ignore_errors=True)



TELEMETRY_TRAIN_STEPS = 8
TELEMETRY_TRAIN_LAG = 8
ADVISE_MTBE_HOURS = (1.0, 24.0, 720.0)


def _obs_off(obs) -> None:
    """Every telemetry surface of the port's switchboard off."""
    obs.disable_metrics()
    obs.set_journal(None)
    obs.disable_trace()
    obs.shutdown()


def _stage_means(obs) -> dict:
    """{stage: (spans, mean ms)} of the stage-duration histograms."""
    out = {}
    for labels in obs.metrics.labels_of("sedar_stage_duration_seconds"):
        h = obs.metrics.get_histogram("sedar_stage_duration_seconds",
                                      **labels)
        out[labels["stage"]] = (h.count, 1e3 * h.total / max(h.count, 1))
    return out


def _snap_line(snap) -> str:
    p = snap.params
    return (f"t_step {p.t_step * 3.6e6:.3f} ms, t_sync "
            f"{p.t_sync * 3.6e6:.3f} ms, MTBE {snap.mtbe_hours:.4g} h, "
            f"confidence {snap.confidence:.3f}, samples {snap.sample_counts}")


def phase_telemetry_serve(kfp, kfa, main, served) -> dict:
    """Slice 6, serving: the telemetry loop (metrics registry, fault
    journal, trace spans, a serve-mode Autotuner) on the serve phase's
    server and params, 8 requests in 4 slots at full width, every run
    under sync-debug "error". (a) Telemetry off and on in turns at lag 8
    (off, on, on, off), then on at lag 1: the same host reads by label,
    the same K1 and K2 launches and the same streams as with it off (the
    tuner estimates and watches but never applies: an applied lag change
    would move the reads); ms/step of each run printed (recorded, not
    gated), and the calibrated t_step/t_sync beside the wall ms/step at
    lag 1 and 8. (b) The lag-8 slot fault (slot 1's logits bit 14 at tick
    5) with the journal on: `obs.reconcile` reproduces the engine's
    detections, recoveries, alerts and reconfigs. (c) Its Chrome trace
    parses and holds the decode_tick, prefill_pack, deferred_flush and
    rollback spans. (d) `python -m repro_torch.launch.serve --continuous
    --metrics-dir --trace --autotune` on the card prints its [obs] and
    [autotune] lines, and `python -m repro_torch.launch.status` renders
    its directory. Returns the kernels' launches in the lag-8 on run."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.configs import RunConfig
    from repro_torch.core import hostsync
    from repro_torch.core import temporal_model as tm
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import Autotuner, AutotuneConfig, make_server

    dev = torch.device("cuda")
    cfg, params = main["cfg"], main["params"]
    dual, clean = served["dual"], served["clean"]
    name = torch.cuda.get_device_name(0)
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="sedar_obs_")

    def since() -> str:
        return f"[telemetry phase +{time.time() - t_phase:.1f} s]"

    def serve(srv, lag, on):
        tuner = journal = trace = None
        if on:
            obs.enable_metrics()
            journal = obs.FaultJournal()
            obs.set_journal(journal)
            trace = obs.enable_trace()
            tuner = Autotuner(tm.PAPER_TABLE3["JACOBI"], AutotuneConfig(
                mode="serve", serve_slots=SERVE_SLOTS, persistence=10 ** 6,
                backend="sequential"))
        kfp.launch_count.reset()
        kfa.launch_count.reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with hostsync.count_transfers(cross_thread=True) as st:
                out, rep = srv.serve(params, serve_requests(),
                                     slots=SERVE_SLOTS, validate_lag=lag,
                                     max_len=SERVE_MAX_LEN, autotune=tuner)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        res = {"out": out, "rep": rep, "reads": st.by_label,
               "counts": {"fingerprint": kfp.launch_count.n,
                          "flash_attention": kfa.launch_count.n},
               "streams": {r.rid: list(r.tokens) for r in out},
               "ms": rep.wall_s / rep.steps * 1e3, "tuner": tuner}
        if on:
            tuner.estimator.ingest(obs.metrics, journal)
            res.update(journal=journal.records(), trace=trace,
                       snap=tuner.estimator.calibrated_params(),
                       stages=_stage_means(obs))
            _obs_off(obs)
        return res

    try:
        # (a) the same reads, launches and streams with telemetry on
        turns = [(on, serve(dual, SERVE_LAG, on))
                 for on in (False, True, True, False)]
        ref = turns[0][1]
        for on, r in turns:
            check(r["streams"] == clean and not r["rep"].detections,
                  f"lag {SERVE_LAG} telemetry {'on' if on else 'off'}: "
                  f"streams differ from the unprotected run")
            check(r["reads"] == ref["reads"],
                  f"lag {SERVE_LAG} telemetry {'on' if on else 'off'}: "
                  f"host reads {r['reads']}, off {ref['reads']}")
            check(r["counts"] == ref["counts"],
                  f"lag {SERVE_LAG} telemetry {'on' if on else 'off'}: "
                  f"launches {r['counts']}, off {ref['counts']}")
        print(f"telemetry on {name}, serve lag {SERVE_LAG} (8 requests, 4 "
              f"slots, full width): the same host reads {ref['reads']}, "
              f"the same launches {ref['counts']} and the same streams "
              f"with metrics, journal, trace and a serve-mode autotuner on "
              f"as off; ms/step (wall / steps) in turns off, on, on, off: "
              + " / ".join(f"{r['ms']:.2f}" for _, r in turns)
              + f" {since()}", flush=True)
        lag1_out, lag1_rep, lag1_reads, lag1_counts = served["lag1"]
        r1 = serve(dual, 1, True)
        check(r1["streams"] == clean and r1["reads"] == lag1_reads
              and r1["counts"] == lag1_counts,
              f"lag 1 telemetry on: reads {r1['reads']} (off "
              f"{lag1_reads}), launches {r1['counts']} (off {lag1_counts})")
        print(f"telemetry on, serve lag 1: the same host reads "
              f"{r1['reads']}, launches {r1['counts']} and streams as the "
              f"serve phase's run with it off; ms/step {r1['ms']:.2f} on, "
              f"{lag1_rep.wall_s / lag1_rep.steps * 1e3:.2f} off (that "
              f"phase) {since()}", flush=True)
        on8 = turns[1][1]
        for lag, r in ((1, r1), (SERVE_LAG, on8)):
            print(f"calibrated from serve lag {lag} (host-clock spans): "
                  f"{_snap_line(r['snap'])}; measured wall "
                  f"{r['ms']:.2f} ms/step; span means (count, ms) "
                  + ", ".join(f"{k} ({n}, {m:.3f})"
                              for k, (n, m) in sorted(r["stages"].items())),
                  flush=True)

        # (b) the journal reproduces the engine on the lag-8 slot fault
        spec = dict(leaf_idx=1, flat_idx=7, bit=BF16_EXP_BIT,
                    step=SERVE_FAULT_TICK, replica=1, target="slot")
        fsrv = make_server(RunConfig(model=cfg), backend="sequential",
                           device=dev, inj_spec=InjectionSpec(**spec))
        rf = serve(fsrv, SERVE_LAG, True)
        eng = fsrv._batch_engines[(SERVE_SLOTS, SERVE_MAX_LEN, SERVE_LAG)][0]
        verdict = obs.reconcile(rf["journal"], eng.detections,
                                eng.recoveries,
                                alerts=rf["tuner"].alerts.records,
                                reconfigs=eng.reconfigs)
        events = [(e.step, e.boundary, e.detail.get("slots"))
                  for e in rf["rep"].detections]
        kinds = [r["kind"] for r in rf["journal"]]
        check(events == [(SERVE_FAULT_TICK, "deferred", [1])]
              and rf["rep"].rollbacks == 1
              and len(rf["rep"].completed) == 8,
              f"journaled lag-{SERVE_LAG} slot fault: events {events}")
        check(all(rf["streams"][r.rid] == clean[r.rid] for r in rf["out"]),
              "journaled slot fault: a stream differs from the clean run")
        check(verdict == {"detections_match": True,
                          "recoveries_match": True, "alerts_match": True,
                          "reconfigs_match": True},
              f"the journal does not reproduce the engine: {verdict}")
        print(f"journaled lag-{SERVE_LAG} slot fault: events {events}, "
              f"journal kinds {kinds}, reconcile {verdict} {since()}",
              flush=True)

        # (c) the trace parses and holds the serving spans
        path = os.path.join(root, "trace.json")
        rf["trace"].write(path)
        with open(path) as fh:
            spans = {}
            for e in json.load(fh)["traceEvents"]:
                spans[e["name"]] = spans.get(e["name"], 0) + 1
        want = {"decode_tick", "prefill_pack", "deferred_flush", "rollback"}
        check(want <= set(spans), f"trace spans {spans}")
        print(f"trace of the fault run ({os.path.getsize(path)} bytes): "
              f"spans {spans}", flush=True)

        # (d) the launcher and the status page, end to end on the card
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
        mdir = os.path.join(root, "launcher")
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               "--continuous", "--validate-lag", str(SERVE_LAG),
               "--metrics-dir", mdir, "--trace",
               os.path.join(mdir, "trace.json"), "--autotune",
               "--autotune-interval", "4"]
        t0 = time.time()
        p = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                           text=True, timeout=600)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith(("[obs] kpis", "[obs] predicted",
                                   "[obs] trace", "[autotune]"))]
        check(p.returncode == 0, f"the serve launcher exited "
              f"{p.returncode}: {p.stderr[-2000:]}")
        check(any(ln.startswith("[obs] kpis") for ln in lines)
              and any(ln.startswith("[autotune] calibrated") for ln in lines),
              f"the serve launcher printed no [obs]/[autotune] lines: "
              f"{p.stdout[-2000:]}")
        print(f"serve launcher with --metrics-dir --trace --autotune on the "
              f"card ({time.time() - t0:.1f} s): "
              + p.stdout.splitlines()[0], flush=True)
        for ln in lines:
            print(f"  {ln}", flush=True)
        s = subprocess.run([sys.executable, "-m", "repro_torch.launch.status",
                            "--metrics-dir", mdir, "--once"], cwd=here,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        check(s.returncode == 0 and "decode_tick" in s.stdout
              and "calibrated:" in s.stdout,
              f"the status page did not render: {s.stdout[-1000:]} "
              f"{s.stderr[-1000:]}")
        print("status page of the launcher's directory:", flush=True)
        for ln in s.stdout.splitlines():
            print(f"  {ln}", flush=True)
    finally:
        _obs_off(obs)
        shutil.rmtree(root, ignore_errors=True)
    print(f"telemetry phase (serving) took {time.time() - t_phase:.1f} s",
          flush=True)
    return on8["counts"]


def phase_telemetry_train(kfp, trainer, make_state, l3) -> int:
    """Slice 6, training: qwen2-0.5b at full width, L3 sequential with the
    validated checkpoint on the device tier (as phase train_backends),
    deferred validation at lag 8, TELEMETRY_TRAIN_STEPS steps, with the
    metrics registry, the journal and a train-mode Autotuner evaluating
    every 2 steps (persistence 1, no confidence floor, so it may retune
    the lag). (e) Every reconfig the tuner applied landed at a clean
    boundary (an empty predicate ring) and stands in `engine.reconfigs`
    and in the journal alike. (f) The losses and K1's launches equal the
    same run with telemetry off, bitwise. Prints the calibrated
    SedarParams and `advise()` on them at an MTBE of 1, 24 and 720 hours.
    Returns K1's launches in the run with telemetry off."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.core import temporal_model as tm
    from repro_torch.core.policy import Autotuner, AutotuneConfig, advise

    t_phase = time.time()
    sedar = dataclasses.replace(l3, ckpt_tiers="device",
                                validate_lag=TELEMETRY_TRAIN_LAG)

    def run(on):
        tr = trainer(f"telemetry_{'on' if on else 'off'}", sedar)
        eng, calls, journal = tr.engine, [], None
        if on:
            obs.enable_metrics()
            journal = obs.FaultJournal()
            obs.set_journal(journal)
            tr.autotune = Autotuner(tm.PAPER_TABLE3["JACOBI"],
                                    AutotuneConfig(
                                        interval_steps=2, persistence=1,
                                        min_confidence=0.0, mode="train",
                                        backend="sequential"))
            apply = eng.apply_reconfig

            def watched(**kw):
                pending = eng.pending_validation
                rec = apply(**kw)
                calls.append((pending, rec))
                return rec
            eng.apply_reconfig = watched
        kfp.launch_count.reset()
        try:
            rep = tr.run(TELEMETRY_TRAIN_STEPS,
                         dual=eng.executor.init_dual(make_state()))[1]
            res = {"rep": rep, "k1": kfp.launch_count.n, "calls": calls,
                   "reconfigs": list(eng.reconfigs)}
            if on:
                est = tr.autotune.estimator
                est.ingest(obs.metrics, journal)
                res.update(
                    journal=journal.records(), snap=est.calibrated_params(),
                    stages=_stage_means(obs),
                    verdict=obs.reconcile(journal.records(), eng.detections,
                                          eng.recoveries,
                                          alerts=tr.autotune.alerts.records,
                                          reconfigs=eng.reconfigs))
        finally:
            _obs_off(obs)
        del tr, eng
        _free()
        return res

    off = run(False)
    on = run(True)
    rep_off, rep_on = off["rep"], on["rep"]
    check(not rep_on.detections and not rep_off.detections
          and rep_on.steps_completed == TELEMETRY_TRAIN_STEPS,
          f"telemetry training runs: {rep_on.summary()} / "
          f"{rep_off.summary()}")
    check(rep_on.losses == rep_off.losses and on["k1"] == off["k1"],
          f"telemetry on changed the losses ({rep_on.losses} vs "
          f"{rep_off.losses}) or K1's launches ({on['k1']} vs {off['k1']})")
    applied = [rec for _, rec in on["calls"] if rec is not None]
    check(all(not pending for pending, rec in on["calls"]
              if rec is not None),
          "a reconfig was applied with predicates pending")
    journaled = [r["record"] for r in on["journal"]
                 if r["kind"] == "reconfig"]
    check(applied == on["reconfigs"] and len(journaled) == len(applied)
          and all(on["verdict"].values()),
          f"reconfigs: applied {applied}, engine {on['reconfigs']}, "
          f"journal {journaled}, reconcile {on['verdict']}")
    ms_on = rep_on.wall_s * 1e3 / TELEMETRY_TRAIN_STEPS
    ms_off = rep_off.wall_s * 1e3 / TELEMETRY_TRAIN_STEPS
    print(f"telemetry on, training (L3 sequential, device tier, lag "
          f"{TELEMETRY_TRAIN_LAG}, {TELEMETRY_TRAIN_STEPS} steps): losses "
          f"and K1's launches ({on['k1']}) bitwise equal to the run with it "
          f"off; ms/step {ms_on:.2f} on, {ms_off:.2f} off; checkpoints "
          f"{rep_on.checkpoints}; reconfigs applied at clean boundaries "
          f"{[(r['step'], r['changes']) for r in applied]}, each in the "
          f"journal; reconcile {on['verdict']}", flush=True)
    snap = on["snap"]
    print(f"calibrated SedarParams from training: {_snap_line(snap)}; span "
          f"means (count, ms) "
          + ", ".join(f"{k} ({n}, {m:.3f})"
                      for k, (n, m) in sorted(on["stages"].items()))
          + "; tier costs (h) "
          + ", ".join(f"{t} save {c.t_save:.3e} restore {c.t_restore:.3e}"
                      for t, c in snap.tier_costs.items()), flush=True)
    for mtbe in ADVISE_MTBE_HOURS:
        a = advise(snap.params, mtbe)
        print(f"advise() on the card's calibration at MTBE {mtbe:g} h: "
              f"strategy {a.strategy}, level {a.level}, t_i {a.t_i:.4g} h, "
              f"validate_lag {a.validate_lag}, tier schedule "
              f"{a.tier_schedule}, serve lag {a.serve_validate_lag}, "
              f"detection {a.detection_mechanism}", flush=True)
    print(f"telemetry phase (training) took {time.time() - t_phase:.1f} s",
          flush=True)
    return off["k1"]


def phase_reference():
    """Small f32 model: the card's path (kernels) against the plain CPU path
    (which the CPU tests hold to the JAX package)."""
    import dataclasses

    from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
    from repro_torch.core.policy import make_server
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              attention_impl="pallas")
    prompt = np.random.RandomState(1).randint(0, 200, (2, 8))
    cpu = make_server(RunConfig(model=cfg), dual=True, device="cpu")
    params = cpu.model.init(seed=0)
    gpu = make_server(RunConfig(model=cfg), dual=True, device="cuda")
    gparams = tree_map(lambda t: t.to("cuda"), params)
    ctoks, _ = cpu.generate(params, {"tokens": prompt}, steps=8)
    gtoks, grep = gpu.generate(gparams, {"tokens": prompt}, steps=8)
    cl, _ = cpu.model.prefill(params, {"tokens": torch.from_numpy(prompt)}, 16)
    gl, _ = gpu.model.prefill(gparams, {"tokens": torch.from_numpy(prompt)
                                        .cuda()}, 16)
    err = float((gl.cpu() - cl).abs().max())
    print(f"small reference (f32): card vs CPU prefill logits max abs err "
          f"{err:.3e}, tokens equal {np.array_equal(ctoks, gtoks)}",
          flush=True)
    check(err <= 1e-4, f"card prefill logits off the CPU path by {err}")
    check(np.array_equal(ctoks, gtoks) and not grep.detections,
          "card tokens differ from the CPU path")


def main() -> None:
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.device import make_deterministic
        from repro_torch.kernels import _build
        from repro_torch.kernels import fingerprint as kfp
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.abft import kernels as kab
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name}", flush=True)
    make_deterministic(torch.device("cuda"))

    t0 = time.time()
    logs = _build.build()
    report = ptxas_report(logs)
    for fn, (regs, spill, smem) in sorted(report.items()):
        print(f"nvcc: {fn}: {regs} registers, {spill} bytes spilled, "
              f"{smem} bytes static shared memory")
    print(f"kernels built in {time.time() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})", flush=True)

    k1 = phase_k1(kfp)
    k2 = phase_k2(kfa)
    k3 = phase_k3(kab)
    phase_campaign(kab)
    campaign_k1 = phase_scenarios(kfp)
    k3["launches"] = phase_engine(kab)
    k4 = phase_k4(kab, kfa, report)
    counts, main_run = phase_main(kfp, kfa, get_config("qwen2-0.5b"))
    phase_abft_serve(kfp, kfa, main_run)
    serve_counts, served = phase_serve(kfp, kfa, main_run)
    telemetry_counts = phase_telemetry_serve(kfp, kfa, main_run, served)
    del main_run, served
    kfp.launch_count.reset()
    train_k1 = phase_train(kfp)
    check(train_k1 > 0, "K1 never launched by the trainer")
    phase_reference()
    # the main path's K1 launches, the training paths' and the replica
    # campaign's, each counted from 0 just before its run
    k1["launches"] = counts["fingerprint"] + train_k1 + campaign_k1
    k2["launches"] = counts["flash_attention"]
    kernels = [k1, k2, k3, k4]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched")
    for k, n in serve_counts.items():
        check(n > 0, f"kernel {k} never launched by serve()")
    for k, n in telemetry_counts.items():
        check(n > 0, f"kernel {k} never launched with telemetry on")
    print(f"chip smoke took {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
