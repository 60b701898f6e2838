"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases a,b,...]

`--phases` runs only the named phases and the phases they take a run from
(`PHASES`, `PHASE_NEEDS`), for iterating on a few; without it every phase
runs, as the contract's run does, and only then is every kernel's launch
count held to be nonzero. The last line is the same either way.

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
  * continuous-batching `SedarServer.serve` of the same model at 2 of its
    24 layers (8 requests in 4 slots, under sync-debug "error"):
    unprotected, dual and fused at
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
  * the model families (phase families): protected `generate()` of
    recurrentgemma-2b (hybrid: RG-LRU blocks and local attention, 5 of
    26 layers, B=2 × 4,096 prompt tokens, K2 at hd 256 with its 2,048
    window), internvl2-2b (vlm: 2 of 24 layers, 256 stub patch embeddings
    + 256 tokens, hd 128), phi3.5-moe (moe, 2 of its 32 layers, hd 128),
    xlstm-125m (ssm, 2 of 12 blocks, 512 prompt tokens) and
    seamless-m4t-medium (audio, 3 + 3 of 12 + 12 layers) at full width
    under none, sequential,
    abft, fused and hybrid in turns (the fused decode of the 2B stacked
    rows bitwise equal to a replica alone in every family, at the host
    position and at per-row positions; equal streams, replica faults
    retried, checksum-block faults corrected forward, hybrid's retry at an
    entry check with no false FSC and its catch of an at-rest flip), and
    K2 at each family's prefill shape against its plain version and SDPA;
  * continuous `serve()` of the moe, ssm and hybrid families (phase
    family_serve): phi3.5-moe (2 layers), xlstm-125m (2 blocks) and
    recurrentgemma-2b (5 layers) at full width, every backend under
    sync-debug "error", slot and
    admission faults, and K1's ring rows against their plain version;
  * protected training of the moe, hybrid, vlm, ssm and audio families
    (phase family_train): phi3.5-moe, recurrentgemma-2b, internvl2-2b,
    xlstm-125m and seamless-m4t-medium at full width (depth cut to fit
    beside a dual run), 4 steps of 4 x 256 tokens (xlstm 4 x 64) under L3
    on the device
    tier with every backend, grads faults under sequential and fused and
    an at-rest flip under hybrid recovered bitwise, peaks, K1's launches
    against the code's count, and K1 on each family's grads and state
    against its plain version;
  * the f32 body of K2 and K4 at hd 128 and 256 (phase f32_wide: the
    internvl2-2b and recurrentgemma-2b prefill shapes against the plain
    versions, K4's bit-23 verdict, SDPA f32 on the MATH backend beside
    them) and protected f32 `generate()` of both models with
    `attention_impl="pallas"` (phase f32_generate: none and sequential,
    equal streams, the first token's logits against the xla attention);
  * the mesh backends (phase pod_train, after phase train): qwen2-0.5b at
    full width trained by `pod` (2 ranks) and `vote` (3 ranks), each
    replica a process of its own over gloo on this one card, under
    sync-debug "error" in every rank: clean runs bitwise equal to the
    sequential trainer's, a pod grads fault localized to its lane and
    restored from the device tier, a vote params fault repaired forward,
    both bitwise equal to the clean run; K1's lanes (L = 1, 2, 8) on the
    full grads against their plain version in phase train;
  * elastic fail-in-place training (phases elastic_train and pod_elastic,
    after pod_train): the training cell under an `ElasticTrainer` whose
    simulated host 1 goes dark at step 2 and returns at 4, in one process
    (full depth, the flat disk: shrink onto data 1, regrow, the full-width
    losses and state bitwise equal to phase train's clean run) and on 4
    pod ranks of a (2, 2) process mesh at 2 of 24 layers (the shrink
    restored from the partner tier onto ranks 0 and 2, every rank bitwise
    equal to its uninterrupted run, no commit_compare read);
  * the chunked attentions (phase chunked, after family_train): one
    qwen2-0.5b layer's attention at S = 4,096 plain against chunked (ms,
    peak, agreement), then one `none` and one `sequential` training step
    of qwen2-0.5b at full width and depth at B = 1, S = 4,096 (the
    reference's train_4k length; peak, ms, K1 on the grads, no detection)
    and one xla prefill at that length;
  * activation rematerialization (phases chunked, remat, plan): the S =
    4,096 steps of phase chunked under remat none, minimal and full (one
    forward + backward's peak in the order full < minimal < none); the
    training cell (4 x 256 tokens, 6 steps) under none, sequential and
    fused at the three policies and a sequential step at B = 8, S =
    4,096 under full, every policy's losses and final fingerprints
    bitwise equal; then `launch/dryrun.py::run_cell`'s predictions (run
    meanwhile in a child process on the host's CPU) beside the measured
    peaks, its state bytes equal to the trainers' exactly. The training
    phases before them pin remat "none" (`PINNED_REMAT`);
  * expert parallelism (phase ep): 2 ranks of a (data 1, model 2) process
    mesh on this card over gloo, one phi3.5-moe layer at full width through
    `Model.loss(ctx=)` (8 experts a rank): loss, aux, drop fraction and
    every grad against the one-process oracle with the tokens in the same
    2 dispatch groups, ms, peak per rank, collectives by label; then the
    same layer with every param sharded over the 2 model ranks (attention
    by heads, the vocab-parallel embedding, head and CE) at f32 compute;
    then the layer served through the sharded serving programs (a prefill
    under SP and 4 decode steps, EP at both) against the one-process
    oracle's blocks;
  * the sharded training program (phase tp, `launch/dryrun.py::
    build_train_program`): qwen2-0.5b at full width on 4 ranks of this
    card, baseline on (data 2, model 2) with sequence parallelism at
    microbatches 1 and 2, sedar on (pod 2, data 1, model 2) clean and
    with a grads fault, against the program on a mesh of one rank in this
    process: losses, step 0's grads, verdicts, the commit gate,
    collectives by label, state bytes as `run_cell` plans them, ms/step,
    peak and gloo bytes per rank;
  * the sharded serving programs (phase tp_serve, `launch/dryrun.py::
    build_prefill_program`, `build_decode_program`): qwen2-0.5b at full
    width and depth on 4 ranks of this card, on (data 2, model 2) (the
    prefill under SP over 7 q heads and 1 kv head a rank, the decode by kv
    heads) and (data 1, model 4) (the prefill by rows, the decode by
    blocks of the head dim), and internvl2-2b (1 layer) on (2, 2), a
    prefill and teacher-forced decode steps against the one-process
    oracle: logits, caches and their bits over two runs, collectives,
    bytes as `plan_ranks` plans them, K2 on each rank's heads or rows and
    at those shapes against its plain version;
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

import dataclasses
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
# the timing turns' lengths (decode steps of `generate()`, training
# steps), 32 and 6 before, halved for the script's time (PERF.md
# section 4): they time, and every check runs on the full-length runs
TURN_STEPS = 16
TURN_TRAIN_STEPS = 3
ENGINE_M = BATCH * PROMPT_LEN    # engine state x (ENGINE_M, ENGINE_N)
ENGINE_N = 896
ENGINE_STEPS = 8
ENGINE_FAULT_STEP = 4
FAULT_BIT = 26    # exponent bit 3: x256 for 2 <= |v| < 256
TRAIN_SEQ = 256
TRAIN_STEPS = 6
TRAIN_BACKENDS = ("none", "sequential", "fused", "abft", "hybrid")
PROFILE_TRIES = 3   # profiles of one measurement that may keep no record
# The training phases that came before activation rematerialization keep
# their times with the remat policy pinned to "none" (the full-size
# configs default to the reference's "full"): the three policies are
# bitwise equal (phases remat and chunked hold them so), so the pin
# changes a run's time and peak, not its numbers (PERF.md section 4)
PINNED_REMAT = "none"


def pinned(cfg):
    """`cfg` with the remat policy of the phases that keep their times."""
    return dataclasses.replace(cfg, remat=PINNED_REMAT)


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


def check_k2(kfa, B: int, S: int, seed: int, what: str, H: int = 14,
             KV: int = 2, hd: int = 64, window: int = 0):
    """K2 against its plain version in bf16 on seeded (B, S) inputs, causal
    (and within `window` when > 0), at qwen2-0.5b's heads unless others
    are given, in the model's layout: elementwise within atol 1e-3 + rtol
    8e-3 (one bf16 rounding step is at most 2^-7 of the value), each row
    within 1e-2 of its largest output, and two launches bitwise equal.
    Returns (q, k, v, max abs err, max error per row's largest value)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # model layout (B, S, heads, hd), viewed as (B, heads, S, hd) as the
    # model's prefill passes it
    q = torch.randn(B, S, H, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    got = kfa.flash_attention_fwd(q, k, v, causal=True, window=window)
    again = kfa.flash_attention_fwd(q, k, v, causal=True, window=window)
    want = kfa.flash_attention_plain(q, k, v, causal=True, window=window)
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


def decode_ms(rep, steps: int = STEPS) -> float:
    """Host wall time per decode step of a generate (prefill excluded)."""
    return (rep.wall_s - rep.prefill_s) / (steps - 1) * 1e3


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
        _, rep = servers[b].generate(params, {"tokens": prompt},
                                     steps=TURN_STEPS)
        times.setdefault(b, []).append(decode_ms(rep, TURN_STEPS))
    print(f"decode ms/step ({TURN_STEPS} steps), same call, in turns none, "
          "sequential (dual), fused, abft, hybrid, then back: " + "; ".join(
              f"{b} {' / '.join(f'{t:.2f}' for t in v)}"
              for b, v in times.items()), flush=True)


SERVE_SLOTS = 4
SERVE_LAG = 8
SERVE_FAULT_TICK = 5
SERVE_MAX_LEN = 256 + 32 + 8
SERVE_TURN_STEPS = 16
# the serve phase's depth: 2 of qwen2-0.5b's 24 layers (8 before the
# chunked, ep and f3 phases came, 4 before the remat phases; cut for the
# script's time: PERF.md section 4)
SERVE_LAYERS = 2
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
    """Continuous-batching `serve()` of the main path's model at full width,
    its depth cut to SERVE_LAYERS with its own seeded params (slot scheduler, packed protected admission through K1 lanes and K2,
    per-slot K1 fingerprints), every serving call under sync-debug
    "error": unprotected, dual at lag 1 and at lag 8 (drain on), then a
    transient slot fault at lag 1 and lag 8, a stuck slot bit and an
    admission fault; the same under `fused` (streams equal sequential lag
    1's); abft and hybrid clean, with a kernel-domain slot fault and an
    admission kernel fault corrected forward; K1's row-limit leaves and K2
    at the fused pack shapes against their plain versions; every backend
    in turns; dual and fused lag-1 profiles. Returns the kernels' launches
    in the dual lag-1 run, and the servers, streams, config and params the
    telemetry phase reuses."""
    import contextlib
    import dataclasses

    from repro_torch.configs import RunConfig
    from repro_torch.core import hostsync
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.device import upload
    from repro_torch.runtime.scheduler import ttft_percentiles_ms

    dev = torch.device("cuda")
    cfg = dataclasses.replace(main["cfg"], num_layers=SERVE_LAYERS)
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
    params = plain.model.init(seed=0)
    print(f"serve phase: {cfg.name} at full width, {cfg.num_layers} of "
          f"{main['cfg'].num_layers} layers, seeded params", flush=True)
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
    return runs[1][3], {"dual": dual, "clean": clean, "lag1": runs[1],
                        "cfg": cfg, "params": params}


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
    params+opt trees against its plain version (and its lanes on the
    grads, `k1_lanes_entry`). Returns (K1's launches in the clean run, the
    K1 lanes entry, the clean L3 run's losses and final per-leaf
    fingerprint: phase_pod_train's oracle)."""
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
    cfg = pinned(get_config("qwen2-0.5b"))
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
            r = t.run(TURN_TRAIN_STEPS,
                      dual=t.engine.executor.init_dual(state))[1]
            check(not r.detections
                  and r.steps_completed == TURN_TRAIN_STEPS,
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
        lanes_entry = k1_lanes_entry(kfp, grads, "the full-width grads")
        # the L3 run's dual state goes before the fused runs (~59 GiB)
        del dual, grads, opt_tree, tr, ftr
        _free()

        for name, t in reversed(turn_order):
            t.run(1, dual=t.engine.executor.init_dual(state))    # warm-up
            r = t.run(TURN_TRAIN_STEPS,
                      dual=t.engine.executor.init_dual(state))[1]
            check(not r.detections, f"{name} training run: {r.summary()}")
            turns[name].append(ms_step(r))
        print(f"training ms/step (wall / steps, {BATCH} x {TRAIN_SEQ} "
              f"tokens, runs of {TURN_TRAIN_STEPS} steps, each after a "
              f"1-step warm-up; two turns each, in "
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
        return k1_launches, lanes_entry, rep.losses, rep.final_state_fp
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


def _l3_k1_launches(backend: str, n_fp: int, sedar,
                    steps: int = TRAIN_STEPS) -> int:
    """K1's launches in a clean L3 run of `steps` steps on the device tier,
    as the code gives them: per checkpoint one per state leaf (the
    validated state's per-leaf fingerprint; the device ring stores no
    digests) and one per state leaf for the final fingerprint. sequential
    and fused: 2 per step on the two replicas' grads and 2 per FSC compare
    (one per replica). none: 1 per step on its grads. hybrid: 1 per commit
    (the resident baseline), 1 per entry check (every
    `param_validate_interval` steps but step 0), 1 per checkpoint (its
    "equal") and 1 for the final validation. abft: nothing more (its
    training step is uninstrumented)."""
    ckpts = steps // sedar.checkpoint_interval
    per_ckpt = n_fp
    if backend in ("sequential", "fused"):
        return (2 * steps + 2 * (steps // sedar.param_validate_interval)
                + ckpts * per_ckpt + n_fp)
    if backend == "none":
        return steps + ckpts * per_ckpt + n_fp
    if backend == "abft":
        return ckpts * per_ckpt + n_fp
    entries = len([s for s in range(1, steps)
                   if s % sedar.param_validate_interval == 0])
    return steps + entries + ckpts * (per_ckpt + 1) + 1 + n_fp


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
    cfg, params = served["cfg"], served["params"]
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


def cut_depth(cfg, depth):
    """`cfg` with `depth` layers (None: as configured); an encoder-decoder
    keeps `depth` layers in each stack."""
    import dataclasses
    if not depth:
        return cfg
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=depth)
    return dataclasses.replace(cfg, num_layers=depth)


FAMILY_STEPS = 32
FAMILY_FAULT_STEPS = 12   # the fused and hybrid fault runs' tokens
FAMILY_INTERVAL = 4       # hybrid's entry check at positions divisible by 4
FAMILY_BACKENDS = ("none", "sequential", "abft", "fused", "hybrid")
# (arch, batch, prompt tokens, layers kept of the config's or None): full
# width, seeded weights; phi3.5-moe's 32 layers would need ~167 GB of f32
# weights, its depth is cut to 8 (~42 GB). xlstm-125m's prompt is 2 mLSTM
# chunks (4 before the remat phases, for the script's time: the sLSTM
# token loop is its prefill); its depth is cut to 2 of 12 blocks (one
# (mLSTM, sLSTM) group) for
# the script's time: its sLSTM token loop took 98.6% of a 12-block prefill
# (3.5-7.5 s each, ~17 per run of this phase), and the script with the
# training phase of the families ran 1,163.9 s at 12 blocks on an NVIDIA
# H100 80GB HBM3 (700 W), against its 1,200 s limit.
# seamless-m4t-medium's encoder takes 1,024 stub frames. Since the elastic
# phases came, for the script's time (PERF.md section 4): recurrentgemma-2b
# keeps 5 of its 26 layers (one (rec, rec, attn) group and the (rec, rec)
# tail, as in FAMILY_SERVE_CASES), internvl2-2b 2 of 24, phi3.5-moe 2 of 32
# and seamless-m4t-medium 3 + 3 of its 12 + 12 (8, 8 and 6 + 6 before the
# chunked, ep and f3 phases came; internvl2-2b and phi3.5-moe 4 before the
# remat phases).
FAMILY_CASES = (("recurrentgemma-2b", 2, 4096, 5),
                ("internvl2-2b", 4, 256, 2),
                ("phi3.5-moe-42b-a6.6b", 4, 256, 2),
                ("xlstm-125m", 4, 512, 2),
                ("seamless-m4t-medium", 4, 256, 3))


def _window_pairs(S: int, W: int) -> int:
    """Unmasked (q, k) pairs of causal attention over S positions, within
    W positions of the query when W > 0."""
    if not W or W >= S:
        return S * (S + 1) // 2
    return W * (W + 1) // 2 + (S - W) * W


def family_k2(kfa, cfg, B: int, S: int, what: str, window=None) -> dict:
    """K2 at a family's prefill shape (its heads, head dim and window, or
    `window` where given): `check_k2`, then timed beside its plain version
    and SDPA with the same mask, and its bound. Returns its kernel-line
    entry."""
    import torch.nn.functional as F
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cfg.window_size if window is None else window
    q, k, v, err, row_err = check_k2(kfa, B, S, S + hd, what, H, KV, hd, W)
    pos = torch.arange(S, device=q.device)
    mask = ((pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
            if W else None)

    def kernel():
        kfa.flash_attention_fwd(q, k, v, causal=True, window=W)

    def sdpa():
        if W:
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           enable_gqa=True)
        else:
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)

    ms, lib_ms = device_ms(kernel, 20), device_ms(sdpa, 20)
    plain_ms = device_ms(
        lambda: kfa.flash_attention_plain(q, k, v, causal=True, window=W), 3)
    flops = 4.0 * B * H * hd * _window_pairs(S, W)
    nbytes = 2.0 * B * S * hd * (2 * H + 2 * KV)
    b_ms, b_by = bound(nbytes, flops)
    print(f"K2 {what} (B={B} H={H}/{KV} S={S} hd={hd} window={W}): max abs "
          f"err {err:.3e}, per row's largest value {row_err:.3e} vs plain "
          f"(bf16), two launches bitwise equal, device {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; bound {b_ms:.5f} ms "
          f"({b_by}), {flops / ms / 1e9:.1f} TFLOP/s on the function's count",
          flush=True)
    return {"name": f"flash_attention_hd{hd}_{what}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:33",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def k2_shape(cfg, B: int, S: int) -> tuple:
    """The key K2's wrapper counts a causal bf16 prefill launch of the
    family's attention under (`launch_count.shapes`)."""
    return (B, cfg.num_heads, cfg.num_kv_heads, S, S, cfg.head_dim, 1,
            cfg.window_size, torch.bfloat16)


def k2_entries(kfa, cfg, shapes, what: str) -> list:
    """One kernels-line entry per K2 shape that a family's runs launched
    (`shapes`, the wrapper's counts by shape): each held against its plain
    version and timed at that very shape (`family_k2`), with that shape's
    launches. Fails on a launch that is not a causal bf16 prefill of the
    family's heads."""
    entries = []
    for key in sorted(shapes, key=lambda t: t[:8]):
        B, S, W = key[0], key[3], key[7]
        check(key == k2_shape(cfg, B, S)[:7] + (W, torch.bfloat16),
              f"{what}: K2 launched at {key}, not a causal bf16 prefill of "
              f"the family's heads")
        e = family_k2(kfa, cfg, B, S, f"{what}_B{B}_S{S}", window=W)
        e["launches"] = shapes[key]
        entries.append(e)
    return entries


def _family_run(kfp, kfa, srv, params, prompt, what: str,
                steps: int = FAMILY_STEPS, max_len=None):
    """One counted generate: kernel counts set to 0 just before, read just
    after; (tokens, report, counts, host reads, peak GiB). A shorter run
    passes the longer run's `max_len`: the cache depth is a shape of the
    decode's products, whose bits can depend on it."""
    from repro_torch.core import hostsync
    torch.cuda.synchronize()
    kfp.launch_count.reset()
    kfa.launch_count.reset()
    torch.cuda.reset_peak_memory_stats()
    with hostsync.count_transfers() as st:
        toks, rep = srv.generate(params, prompt, steps=steps,
                                 max_len=max_len)
    counts = {"fingerprint": kfp.launch_count.n,
              "flash_attention": kfa.launch_count.n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = [(e.step, e.boundary, e.effect) for e in rep.detections]
    print(f"  {what}: prefill+first token {rep.prefill_s * 1e3:.1f} ms, "
          f"decode {decode_ms(rep, steps):.2f} ms/step, launches "
          f"{counts}, host reads {st.by_label}, detections {events[:3]}"
          f"{' ...' if len(events) > 3 else ''}, retries {rep.retries}, "
          f"stopped {rep.stopped}, peak {peak:.2f} GiB", flush=True)
    return toks, rep, counts, st.by_label


STACKED_STEPS = 8


def stacked_decode_bits(model, params, prompt, pos: int, what: str) -> None:
    """The fused backend's decode of a family, bit for bit on the card: one
    prefill of B rows, its cache stacked twice along each leaf's slot axis,
    then STACKED_STEPS greedy steps of the B rows alone against the 2B
    stacked rows decoded together (`Model.decode_step(row_blocks=2)`: the
    attention, the feature means and xlstm's gate products per block,
    `layers.row_blocks`, every other op stacked), at the host position
    (generate()) and, for a family `serve()` takes, at per-row positions
    (each row its own MoE dispatch group). Prints each and fails unless
    both halves of every step's logits equal the replica's."""
    cfg, dev = model.cfg, torch.device("cuda")
    B = prompt["tokens"].shape[0]
    _, cache0 = model.prefill(params, prompt, pos + STACKED_STEPS + 8)
    axes = model.slot_axes()
    row_pos = [False] + ([True] if cfg.family in ("moe", "hybrid", "ssm")
                         else [])
    from repro_torch.tree import tree_map
    for per_row in row_pos:
        one = tree_map(lambda c: c.clone(), cache0)
        two = tree_map(lambda c, ax: torch.cat([c, c], dim=ax), cache0, axes)
        tok = prompt["tokens"][:, -1]
        first, worst = None, 0.0
        for s in range(STACKED_STEPS):
            p1 = torch.full((B,), pos + s, device=dev) if per_row else pos + s
            p2 = torch.cat([p1, p1]) if per_row else p1
            l1, one = model.decode_step(params, one, tok, p1)
            l2, two = model.decode_step(params, two, torch.cat([tok, tok]),
                                        p2, row_blocks=2)
            if first is None and not (torch.equal(l1, l2[:B])
                                      and torch.equal(l1, l2[B:])):
                first = s
            worst = max(worst, float((l2.float() - torch.cat([l1, l1])
                                      .float()).abs().max()))
            tok = torch.argmax(l1, -1)
        print(f"  stacked decode ({'per-row' if per_row else 'host'} "
              f"positions, {STACKED_STEPS} steps from {pos}): 2B rows "
              f"together bitwise equal to a replica alone {first is None}"
              f"{'' if first is None else f' (first off at step {first})'}"
              f", max |dlogit| {worst:.3e}", flush=True)
        check(first is None, f"{what}: the stacked decode lost a replica's "
              f"bits at step {first} ({'per-row' if per_row else 'host'} "
              f"positions, max |dlogit| {worst:.3e})")


def family_decode_profile(srv, params, prompt, pos: int, what: str) -> None:
    """Where one unprotected decode step's time goes (profiler on): the
    device-busy share of its wall, the shares of the copy kernels (the f32
    to bf16 weight casts of the eager step) and of the fill kernels
    (deterministic mode fills each fresh output, the casts' too), and the
    kernels that take the device time."""
    logits, cache = srv.model.prefill(params, prompt, pos + FAMILY_STEPS + 8)
    tok = torch.argmax(logits, dim=-1)
    del logits

    def step():
        srv.model.decode_step(params, cache, tok, pos)

    step()
    torch.cuda.synchronize()
    wall_ms, busy_ms, launches, kern, calls = device_profile(step)
    def share(word):
        return sum(e.self_device_time_total for e in kern
                   if word in e.key.lower()) / 1e3

    copy_ms, fill_ms = share("copy"), share("fill")
    print(f"  profile of one {what} decode step (none, profiler on): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), copy kernels {copy_ms:.2f} ms "
          f"({100 * copy_ms / busy_ms:.1f}% of busy), fill kernels "
          f"{fill_ms:.2f} ms ({100 * fill_ms / busy_ms:.1f}%), {launches} "
          f"kernels, {calls} launch calls", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    del cache, tok


def clean_logits(srv, params, prompt, toks, pos: int, step: int):
    """The clean (B, V) logits at decode position `step`, from the
    unprotected model fed the clean tokens (f32, on the host)."""
    logits, cache = srv.model.prefill(params, prompt, pos + FAMILY_STEPS + 8)
    tk = torch.from_numpy(toks).to(logits.device)
    for p in range(pos, step + 1):
        logits, cache = srv.model.decode_step(params, cache, tk[:, p - pos], p)
    out = logits.float().cpu().numpy()
    del logits, cache
    return out


def abft_fault_column(srv, params, prompt, toks, pos: int, step: int,
                      what: str):
    """(column, clean logit (1, 5)): the column of the abft fault in row 1
    of the logits block at decode position `step` is 5, or the first
    column after it whose clean logit lies in (-1, 1), where a flip of bit
    30 scales the value by 2**128, far above the checksum threshold. At
    |v| in [1, 2) the flip makes a NaN, which the reference's guard misses
    and the port's flags uncorrectable (F3); at |v| >= 2 it shrinks the
    value by 2**-128, a change below the threshold. Fails if no column
    qualifies.
    The clean logits come from the unprotected model fed the clean
    tokens."""
    row = clean_logits(srv, params, prompt, toks, pos, step)[1]
    small = np.abs(row[5:]) < 1.0
    check(bool(small.any()), f"{what}: no clean logit of row 1 from column "
          f"5 on lies in (-1, 1) at position {step}")
    col = 5 + int(np.argmax(small))
    v = float(row[5])
    case = ("bit 30 scales it by 2**128" if abs(v) < 1 else
            "bit 30 makes a NaN, uncorrectable (F3)" if abs(v) < 2 else
            "bit 30 shrinks it below the checksum threshold")
    print(f"  {what}: clean logit (1, 5) at position {step} is {v!r}: "
          f"{case}; the abft fault goes to (1, {col}), clean logit "
          f"{float(row[col])!r}", flush=True)
    return col, v


def slstm_prefill_share(srv, params, prompt, max_len: int) -> None:
    """How much of an xLSTM prefill the sLSTM blocks take (their token loop
    is host-dispatched, one small step per token): one prefill timed on
    the host clock with the card synchronized around it and around each
    sLSTM block (the syncs stall the queue, so both times include it)."""
    from repro_torch.models import xlstm

    block, spent = xlstm.slstm_block, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = block(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    xlstm.slstm_block = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.model.prefill(params, prompt, max_len)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        xlstm.slstm_block = block
    print(f"  xlstm prefill (synchronized per sLSTM block): {total * 1e3:.1f} "
          f"ms, of which the {len(spent)} sLSTM blocks {sum(spent) * 1e3:.1f} "
          f"ms ({100 * sum(spent) / total:.1f}%)", flush=True)


def family_faults(kfp, kfa, cfg, params, prompt, toks, pos: int, step: int,
                  col: int, final_ln: int, plain, arch: str) -> None:
    """Slice 9's fault runs of one family, FAMILY_FAULT_STEPS tokens each:
    fused, the final_ln fault on replica 1 at `step` (detected, retried);
    hybrid, the abft fault at (1, `col`) corrected forward, an uncorrectable
    pair of logits flips at an entry-check position (retried, no FSC: the
    failed attempt's in-place cache row or ring slot is outside the
    baseline) and, for the ring and recurrent families, an at-rest flip of
    a live ring slot or recurrent state before an entry check (FSC there,
    at every retry, then the safe stop, as in the reference)."""
    import dataclasses

    from repro_torch.configs import RunConfig, SedarConfig
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.tree import flatten_with_path

    dev = torch.device("cuda")
    V, n = cfg.vocab_size, FAMILY_FAULT_STEPS
    want = toks[:, :n]
    rc_h = RunConfig(model=cfg, sedar=SedarConfig(
        param_validate_interval=FAMILY_INTERVAL))

    def run(backend, spec, what, flip=None):
        srv = make_server(rc_h if backend == "hybrid" else RunConfig(
            model=cfg), backend=backend, device=dev, inj_spec=spec)
        if flip is not None:
            at, fn = flip
            execute = srv.engine.executor.execute

            def flipped(dual, batch, s, armed, compare):
                if s == at:
                    fn(dual["r0"]["cache"], s)
                return execute(dual, batch, s, armed, compare)
            srv.engine.executor.execute = flipped
        out = _family_run(kfp, kfa, srv, params, prompt, what, steps=n,
                          max_len=pos + FAMILY_STEPS + 8)
        del srv
        return out

    def events(rep):
        return [(e.step, e.boundary, e.effect,
                 bool(e.detail.get("abft_corrected"))) for e in rep.detections]

    ftoks, frep, _, _ = run("fused", InjectionSpec(
        leaf_idx=final_ln, flat_idx=3, bit=30, step=step, replica=1,
        target="params"), "fused fault")
    check(events(frep) == [(step, "commit", "TDC", False)]
          and frep.retries == 1 and not frep.stopped
          and np.array_equal(ftoks, want),
          f"{arch}: fused final_ln fault: events {events(frep)}, retries "
          f"{frep.retries}, tokens equal {np.array_equal(ftoks, want)}")
    ftoks, frep, _, _ = run("hybrid", InjectionSpec(
        leaf_idx=0, flat_idx=1 * (V + 1) + col, bit=30, step=step, replica=0,
        target="kernel"), "hybrid logits fault")
    check(events(frep) == [(step, "commit", "TDC", True)]
          and frep.retries == 0 and np.array_equal(ftoks, want),
          f"{arch}: hybrid logits fault not corrected forward: "
          f"{events(frep)}")
    # an entry-check position, and two logits of rows 0 and 1 in (-1, 1)
    # one column apart: bit 30 scales both by 2**128, two rows and two
    # columns of residuals fail, so the guard cannot correct it
    estep = pos + 2 + (-(pos + 2)) % FAMILY_INTERVAL
    lg = np.abs(clean_logits(plain, params, prompt, toks, pos, estep)) < 1.0
    pair = lg[0, 5:-1] & lg[1, 6:]
    check(bool(pair.any()), f"{arch}: no pair of small logits at {estep}")
    c = 5 + int(np.argmax(pair))
    ftoks, frep, _, reads = run("hybrid", InjectionSpec(
        leaf_idx=0, flat_idx=c, bit=30, step=estep, replica=0,
        target="kernel", n_elems=2), "hybrid uncorrectable at an entry check")
    check(events(frep) == [(estep, "commit", "TDC", False)]
          and frep.retries == 1 and not frep.stopped
          and np.array_equal(ftoks, want),
          f"{arch}: hybrid retry at entry-check position {estep}: events "
          f"{events(frep)} (a false FSC would follow the TDC), retries "
          f"{frep.retries}")
    print(f"  hybrid: uncorrectable flips at (0, {c}) and (1, {c + 1}) at "
          f"entry-check position {estep} retried with no FSC; host reads "
          f"{reads}", flush=True)
    if cfg.family not in ("hybrid", "ssm"):
        return
    W = cfg.window_size
    path = ("['groups']['b2_attention']['k']" if cfg.family == "hybrid"
            else "['groups']['b0_mlstm']['C']")

    def flip(cache, s):
        leaf = dict(flatten_with_path(cache))[path]
        if cfg.family == "hybrid":      # the ring slot position s - 1 fills
            leaf[0, 1, (s - 1) % W, 0, 7] += 1.0
        else:
            leaf[0, 1, 2, 3, 4] += 1.0
    ftoks, frep, _, _ = run("hybrid", None, "hybrid at-rest flip",
                            flip=(estep, flip))
    ev = events(frep)
    check(ev and all(e == (estep, "validate", "FSC", False) for e in ev)
          and frep.stopped,
          f"{arch}: at-rest flip of {path} before {estep}: events {ev}, "
          f"stopped {frep.stopped}")
    print(f"  hybrid: at-rest flip of {path} before position {estep} caught "
          f"at its entry check ({len(ev)} FSC events, then the safe stop, "
          f"as in the reference)", flush=True)


def phase_families(kfp, kfa):
    """Slices 7 to 9: protected generate() of the hybrid
    (recurrentgemma-2b), vlm (internvl2-2b), moe (phi3.5-moe, 4 of 32
    layers), ssm (xlstm-125m) and audio (seamless-m4t-medium) families at
    full width with seeded weights and K2 prefill, under none, sequential,
    abft, fused and hybrid in turns: equal streams, no detection on a clean
    run, a final_ln bit-30 fault on replica 1 detected and retried
    (sequential and fused), a logits element of the abft checksum block
    corrected forward (abft and hybrid), all with the clean tokens; under
    hybrid an uncorrectable logits fault at an entry-check position retried
    with no false FSC, and (recurrentgemma, xlstm) an at-rest flip of a live
    ring slot or a recurrent state caught at the next entry check. Before
    the runs, the fused backend's stacked decode against a replica alone
    (`stacked_decode_bits`), which must keep the bits in every family.
    One unprotected decode step
    of each family is profiled. Then K2 at each
    attention family's prefill shape (xlstm has none). Returns (K1
    launches, the K2 kernel-line entries, one per family's shape, with
    that family's launches)."""
    import dataclasses

    from repro_torch.configs import RunConfig, SedarConfig, get_config
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.models import moe, transformer as tfm
    from repro_torch.tree import flatten_with_path, leaves

    t_phase = time.time()
    dev = torch.device("cuda")
    k1_total, entries = 0, []
    for arch, B, S, depth in FAMILY_CASES:
        t_model = time.time()
        cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
        cfg = cut_depth(cfg, depth)
        rng = np.random.RandomState(7)
        prompt = {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (B, S))).to(dev)}
        if cfg.frontend:        # vlm patches or audio frames
            prompt["frontend_embeds"] = 0.1 * torch.from_numpy(
                rng.standard_normal((B, cfg.frontend_seq, cfg.frontend_dim)
                                    ).astype(np.float32)).to(dev)
        # decode positions count a vlm's patches, not an encoder's frames
        P = cfg.frontend_seq if cfg.family == "vlm" else 0
        rc_h = RunConfig(model=cfg, sedar=SedarConfig(
            param_validate_interval=FAMILY_INTERVAL))
        servers = {b: make_server(rc_h if b == "hybrid" else
                                  RunConfig(model=cfg), backend=b, device=dev)
                   for b in FAMILY_BACKENDS}
        t0 = time.time()
        params = servers["none"].model.init(seed=0)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in leaves(params))
        attn_layers = (sum(k == "attention" for k in cfg.block_pattern)
                       * (cfg.num_layers // len(cfg.block_pattern))
                       + sum(k == "attention" for k in tfm.pattern_tail(cfg))
                       if cfg.block_pattern else cfg.num_layers)
        print(f"families: {cfg.name} [{cfg.family}] {cfg.num_layers}L "
              f"d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
              f"hd={cfg.head_dim} V={cfg.vocab_size} window="
              f"{cfg.window_size}, {n_params / 1e9:.2f}B f32 params (seeded "
              f"init {time.time() - t0:.2f} s), B={B} prompt={S}"
              f"{f' + {cfg.frontend_seq} {cfg.frontend}' if cfg.frontend else ''}"
              f" steps={FAMILY_STEPS}, decode from {S + P}", flush=True)
        if cfg.family == "moe":
            _, _, aux = tfm.lm_hidden(cfg, params, prompt["tokens"])
            print(f"  moe prefill drop fraction {float(aux['moe_drop_frac'])}"
                  f" (capacity factor {moe.CAPACITY_FACTOR}, "
                  f"{moe.capacity(cfg, B * S)} per expert, {B * S} tokens, top-"
                  f"{cfg.experts_per_token} of {cfg.num_experts}), aux loss "
                  f"{float(aux['moe_aux']):.4f}", flush=True)
            del aux
        servers["none"].generate(params, prompt, steps=2)      # warm-up
        stacked_decode_bits(servers["none"].model, params, prompt, S + P,
                            arch)
        runs = {}
        for b in FAMILY_BACKENDS:
            runs[b] = _family_run(kfp, kfa, servers[b], params, prompt,
                                  f"{b} clean")
        toks = runs["none"][0]
        check(toks.shape == (B, FAMILY_STEPS)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{arch}: tokens {toks.shape} out of range")
        for b, (t, rep, counts, reads) in runs.items():
            check(np.array_equal(t, toks), f"{arch}: {b} tokens differ from "
                  f"the unprotected run")
            check(not rep.detections and not rep.stopped,
                  f"{arch}: clean {b} run detected "
                  f"{[str(e) for e in rep.detections]}")
            check(counts["flash_attention"] == attn_layers,
                  f"{arch}: K2 launched {counts['flash_attention']} != "
                  f"{attn_layers} times under {b}")
        check(runs["sequential"][2]["fingerprint"] == 2 * (FAMILY_STEPS - 1),
              f"{arch}: K1 launched {runs['sequential'][2]['fingerprint']} "
              f"!= {2 * (FAMILY_STEPS - 1)} times under sequential")
        check(runs["sequential"][3] == {"commit_compare": FAMILY_STEPS - 1,
                                        "token_emit": FAMILY_STEPS},
              f"{arch}: sequential host reads {runs['sequential'][3]}")
        check(runs["fused"][2]["fingerprint"] == 2 * (FAMILY_STEPS - 1)
              and runs["fused"][3] == runs["sequential"][3],
              f"{arch}: fused K1 {runs['fused'][2]} host reads "
              f"{runs['fused'][3]}")
        checks = runs["hybrid"][3].get("state_validate", 0)
        check(checks > 0 and runs["hybrid"][3] == {
                  "abft_verdict": FAMILY_STEPS - 1, "token_emit": FAMILY_STEPS,
                  "state_validate": checks}
              and runs["hybrid"][2]["fingerprint"]
              == FAMILY_STEPS - 1 + checks,
              f"{arch}: hybrid K1 {runs['hybrid'][2]} (one resident "
              f"fingerprint per commit and per entry check), host reads "
              f"{runs['hybrid'][3]}")
        k2_launches, k2_shapes = 0, set()
        for b in FAMILY_BACKENDS[::-1]:    # in turns, again
            _, rep, counts, _ = _family_run(kfp, kfa, servers[b], params,
                                            prompt, f"{b} clean (turn 2)")
            check(not rep.detections, f"{arch}: clean {b} detected")
            k1_total += counts["fingerprint"]
            k2_launches += counts["flash_attention"]
            k2_shapes |= set(kfa.launch_count.shapes)
        check(k2_shapes == ({k2_shape(cfg, B, S + P)} if attn_layers
                            else set()),
              f"{arch}: K2 launched at {sorted(k2_shapes, key=str)}, not "
              f"only at the prefill shape it is held at below")
        family_decode_profile(servers["none"], params, prompt, S + P, arch)
        if cfg.family == "ssm":
            slstm_prefill_share(servers["none"], params, prompt,
                                S + FAMILY_STEPS + 8)

        step = S + P + 5
        final_ln = [p for p, _ in flatten_with_path(params)].index(
            "['decoder']['final_ln']" if cfg.family == "audio"
            else "['final_ln']")
        col, v5 = abft_fault_column(servers["none"], params, prompt, toks,
                                    S + P, step, arch)
        specs = {"sequential": InjectionSpec(
                     leaf_idx=final_ln, flat_idx=3, bit=30, step=step,
                     replica=1, target="params"),
                 "abft": InjectionSpec(
                     leaf_idx=0, flat_idx=1 * (cfg.vocab_size + 1) + col,
                     bit=30, step=step, replica=0, target="kernel")}
        if col != 5:
            # the protocol's own element, (1, 5), where the flip is no
            # fault the guard corrects: its outcome is checked. A NaN (F3)
            # fails its row and column: uncorrectable, the step retried, the
            # clean tokens (the reference lets it through); a shrunk value
            # is below the threshold and the guard cannot see it
            fsrv = make_server(RunConfig(model=cfg), backend="abft",
                               device=dev, inj_spec=dataclasses.replace(
                                   specs["abft"], flat_idx=cfg.vocab_size + 6))
            ftoks, frep, _, _ = _family_run(kfp, kfa, fsrv, params, prompt,
                                            "abft fault at (1, 5)")
            t = step - (S + P) + 1          # the token decoded at `step`
            events = [(e.step, e.boundary, e.effect,
                       bool(e.detail.get("abft_corrected")))
                      for e in frep.detections]
            print(f"  abft fault at (1, 5): events {events}, retries "
                  f"{frep.retries}, tokens equal the clean run "
                  f"{np.array_equal(ftoks, toks)}; row 1 emits "
                  f"{int(ftoks[1, t])} at position {step} (clean "
                  f"{int(toks[1, t])})", flush=True)
            if abs(v5) < 2:
                check(events == [(step, "commit", "TDC", False)]
                      and frep.retries == 1 and not frep.stopped
                      and np.array_equal(ftoks, toks),
                      f"{arch}: F3's NaN at (1, 5) (clean logit {v5!r}): "
                      f"events {events}, retries {frep.retries}, or the "
                      f"tokens differ from the clean run")
            else:
                check(not frep.detections and frep.retries == 0
                      and not frep.stopped,
                      f"{arch}: abft fault at (1, 5) (clean logit {v5!r}): "
                      f"detections {[str(e) for e in frep.detections]}, "
                      f"retries {frep.retries}, the guard cannot see it")
            del fsrv
        for b, spec in specs.items():
            fsrv = make_server(RunConfig(model=cfg), backend=b, device=dev,
                               inj_spec=spec)
            ftoks, frep, _, _ = _family_run(kfp, kfa, fsrv, params, prompt,
                                            f"{b} fault")
            events = [(e.step, e.boundary, e.effect) for e in frep.detections]
            check(events == [(step, "commit", "TDC")],
                  f"{arch}: {b} fault events {events}")
            if b == "sequential":
                check(frep.retries == 1, f"{arch}: retries {frep.retries}")
            else:
                check(frep.retries == 0 and bool(
                    frep.detections[0].detail.get("abft_corrected")),
                      f"{arch}: abft fault not corrected forward")
            check(not frep.stopped and np.array_equal(ftoks, toks),
                  f"{arch}: {b} fault run changed the tokens")
            del fsrv
        family_faults(kfp, kfa, cfg, params, prompt, toks, S + P, step, col,
                      final_ln, servers["none"], arch)
        del servers, params, runs
        _free()
        if attn_layers:         # the decoder's self-attention for audio
            entry = family_k2(kfa, cfg, B, S + P, arch)
            entry["launches"] = k2_launches
            entries.append(entry)
        torch.cuda.empty_cache()
        print(f"families: {arch} at {cfg.num_layers} layers took "
              f"{time.time() - t_model:.1f} s", flush=True)
    print(f"families phase took {time.time() - t_phase:.1f} s", flush=True)
    return k1_total, entries


# (arch, layers kept or None, prompt lengths): full width, seeded weights.
# recurrentgemma's prompts straddle its 2,048 window: a 2,040-token prompt
# wraps the ring during decode, 2,100 and 4,096 start wrapped at other
# phases. xlstm-125m keeps 2 of its 12 blocks, for the script's time (as in
# FAMILY_CASES: its B=1 admissions are the sLSTM token loop). For the same
# reason, once the f32 and mesh phases came, phi3.5-moe keeps 2 of 32 layers
# (its abft admission target, logit (0, 5), lies in [1, 2) there: bit 30
# makes a NaN, which the guard flags uncorrectable since F3's repair, and
# the admission is retried) and recurrentgemma-2b 5 of 26 (one (rec, rec,
# attn) group and the (rec, rec) tail, the full model's structure; 8 before
# the chunked, ep and f3 phases came): this
# phase took 190.0 s at 8 and 26 layers and 100.3 s at 4 and 8, the rest of
# the script ~750 s, against a 1,050 s target within the 1,200 s limit
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §4).
FAMILY_SERVE_CASES = (("phi3.5-moe-42b-a6.6b", 2, (96, 200, 256)),
                      ("xlstm-125m", 2, (96, 200, 256)),
                      ("recurrentgemma-2b", 5, (2040, 2100, 4096)))


def phase_family_serve(kfp, kfa) -> dict:
    """Slice 9: continuous serve() of the moe (phi3.5-moe, 2 of 32 layers),
    ssm (xlstm-125m) and hybrid (recurrentgemma-2b) families at full width,
    8 requests in 4 slots (arrivals 0.5 per tick, budgets 16 or 32),
    every run under sync-debug "error": none, sequential at lag 1 and 8,
    fused, abft and hybrid, each completed stream equal to sequential's
    at the same lag, lag 8 reading nothing per tick; a slot fault (slot
    1's logits bit 14 at tick 5) at lag 1 and 8, sequential and fused,
    recovered with the clean streams. phi3.5-moe admits through protected
    packs of one prompt in these runs (`max_pack=1`: a MoE pack routes its
    prompts together, so with others in its pack a stream would hang on
    admission timing, which the lag and a rollback move), its decode drops
    no token (one dispatch group of one token per slot, capacity 4), and
    an admission fault at tick 0 is caught (sequential; abft where bit 30
    makes the target a NaN, F3) or corrected (abft) in the pack; then at the server's default `max_pack` (packs of
    up to 4 prompts of one exact length, no pad) the traffic at lag 8 and
    a burst of 8 prompts at tick 0 at lag 1 and 8 fill packs of two, 0
    detections, fused equal to sequential at the same lag. ms/step, tokens/s,
    K1/K2 launches and peak memory per family and backend; then K2 at each
    shape these runs launched it (`k2_entries`). Returns ({arch: each
    kernel's launches in these runs}, the K2 kernels-line entries)."""
    import collections
    import contextlib
    import dataclasses

    from repro_torch.configs import RunConfig, SedarConfig, get_config
    from repro_torch.core import hostsync
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.models import moe, transformer as tfm
    from repro_torch.runtime.scheduler import Request, synthetic_requests

    t_phase = time.time()
    dev = torch.device("cuda")
    totals, entries = {}, []

    def since() -> str:
        return f"[family serve phase +{time.time() - t_phase:.1f} s]"

    @contextlib.contextmanager
    def strict():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    for arch, depth, lengths in FAMILY_SERVE_CASES:
        t_model = time.time()
        cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
        cfg = cut_depth(cfg, depth)
        max_len = max(lengths) + 32 + 8
        totals[arch] = {"fingerprint": 0, "flash_attention": 0}
        k2_shapes = collections.Counter()
        is_moe = cfg.family == "moe"
        kw = {"max_pack": 1} if is_moe else {}
        rc = RunConfig(model=cfg)
        rc_h = RunConfig(model=cfg, sedar=SedarConfig(
            param_validate_interval=8))
        servers = {b: make_server(rc_h if b == "hybrid" else rc, backend=b,
                                  device=dev, **kw)
                   for b in ("none", "sequential", "fused", "abft", "hybrid")}
        params = servers["none"].model.init(seed=0)
        attn = (sum(k == "attention" for k in cfg.block_pattern)
                * (cfg.num_layers // len(cfg.block_pattern))
                + sum(k == "attention" for k in tfm.pattern_tail(cfg))
                if cfg.block_pattern else cfg.num_layers)
        print(f"family serve: {cfg.name} [{cfg.family}] {cfg.num_layers}L "
              f"d={cfg.d_model}, prompts {lengths}, 8 requests in "
              f"{SERVE_SLOTS} slots, max_len {max_len}"
              f"{', max_pack 1' if is_moe else ''}", flush=True)

        def requests():
            return synthetic_requests(8, arrival_rate=0.5,
                                      prompt_lengths=lengths,
                                      max_new_choices=(16, 32),
                                      vocab=cfg.vocab_size, seed=0)

        def burst():
            # 8 prompts at tick 0, two lengths: exact-length packs of two
            rng = np.random.RandomState(1)
            return [Request(rid=i, prompt=rng.randint(
                        0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=(16, 32)[i % 2], arrival=0)
                    for i, n in enumerate((96, 96, 256, 256) * 2)]

        def serve(srv, lag, what, traffic=requests, **skw):
            torch.cuda.synchronize()
            kfp.launch_count.reset()
            kfa.launch_count.reset()
            torch.cuda.reset_peak_memory_stats()
            with strict(), hostsync.count_transfers(cross_thread=True) as st:
                out, rep = srv.serve(params, traffic(), slots=SERVE_SLOTS,
                                     validate_lag=lag, max_len=max_len,
                                     **skw)
            torch.cuda.synchronize()
            counts = {"fingerprint": kfp.launch_count.n,
                      "flash_attention": kfa.launch_count.n}
            k2_shapes.update(kfa.launch_count.shapes)
            for k in counts:
                totals[arch][k] += counts[k]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            events = [(e.step, e.boundary, e.effect, e.detail.get("slots"))
                      for e in rep.detections]
            print(f"  {what} lag {lag}: {rep.steps} steps, "
                  f"{rep.prefill_packs} packs, {rep.tokens_emitted} tokens, "
                  f"{rep.wall_s / max(rep.steps, 1) * 1e3:.2f} ms/step "
                  f"(wall / steps, admission included), "
                  f"{rep.tokens_per_s:.1f} tokens/s, launches {counts}, host "
                  f"reads {reads_str(st.by_label)}, events {events[:3]}, "
                  f"retries {rep.retries}, rollbacks {rep.rollbacks}, "
                  f"completed {len(rep.completed)}, peak {peak:.2f} GiB "
                  f"{since()}", flush=True)
            return out, rep, st.by_label, counts, events

        def reads_str(reads):
            return {k: v for k, v in sorted(reads.items())}

        drops = []
        if is_moe:
            # every decode MoE call's drop fraction, kept on the device
            mlp = moe.moe_mlp

            def spy(cfg_, p, x, groups=1, ctx=None):
                out = mlp(cfg_, p, x, groups, ctx=ctx)
                if x.shape[1] == 1:
                    drops.append(out[1]["moe_drop_frac"])
                return out
            moe.moe_mlp = spy
        try:
            ref, rep_ref, reads_ref, counts_ref, _ = serve(
                servers["sequential"], 1, "sequential")
        finally:
            if is_moe:
                moe.moe_mlp = mlp
        clean = {1: {r.rid: list(r.tokens) for r in ref}}
        check(sorted(rep_ref.completed) == list(range(8))
              and not rep_ref.detections
              and all(len(t) == r.max_new_tokens
                      and all(0 <= x < cfg.vocab_size for x in t)
                      for r, t in zip(ref, clean[1].values())),
              f"{arch}: clean sequential serve: completed "
              f"{rep_ref.completed}")
        if is_moe:
            worst = float(torch.stack(drops).max())
            check(worst == 0.0, f"{arch}: a decode MoE call dropped "
                  f"{worst} of its pairs")
            print(f"  moe decode: {len(drops)} MoE calls (one dispatch group "
                  f"of one token per slot, capacity "
                  f"{moe.capacity(cfg, 1)}), largest drop fraction {worst}",
                  flush=True)
            check(rep_ref.prefill_packs == 8
                  and counts_ref["flash_attention"]
                  == 2 * cfg.num_layers * rep_ref.prefill_packs,
                  f"{arch}: admission not through the protected packs: "
                  f"{rep_ref.prefill_packs} packs, K2 {counts_ref}")
        else:
            check(rep_ref.prefill_packs == 0
                  and counts_ref["flash_attention"] == 8 * attn
                  and counts_ref["fingerprint"]
                  == 2 * SERVE_SLOTS * rep_ref.steps,
                  f"{arch}: admission not the exact B=1 prefill, or K1/K2 "
                  f"{counts_ref} for {rep_ref.steps} steps")
        for b, lag in (("sequential", SERVE_LAG), ("none", 1), ("fused", 1),
                       ("fused", SERVE_LAG), ("abft", 1), ("hybrid", 1)):
            out, rep, reads, counts, _ = serve(servers[b], lag, b)
            streams = {r.rid: list(r.tokens) for r in out}
            if lag not in clean:
                clean[lag] = streams
                print(f"  sequential lag {lag} streams equal lag 1's: "
                      f"{streams == clean[1]}", flush=True)
                check(streams == clean[1], f"{arch}: sequential lag {lag} "
                      f"streams differ from lag 1's")
            check(not rep.detections and sorted(rep.completed)
                  == list(range(8)) and streams == clean[lag],
                  f"{arch}: clean {b} lag {lag}: events "
                  f"{[str(e) for e in rep.detections]} or streams differ "
                  f"from sequential lag {lag}")
            if lag > 1:
                check(set(reads) == {"prefill_emit", "token_emit"}
                      and reads["token_emit"]
                      <= 3 * (rep.steps // SERVE_LAG + 2),
                      f"{arch}: {b} lag {lag} reads per tick: {reads}")
            if b == "hybrid":
                check(reads.get("state_validate", 0) > 0,
                      f"{arch}: hybrid serve ran no entry check")

        slot_fault = dict(leaf_idx=1, flat_idx=7, bit=BF16_EXP_BIT,
                          step=SERVE_FAULT_TICK, replica=1, target="slot")
        for b in ("sequential", "fused"):
            for lag in (1, SERVE_LAG):
                srv = make_server(rc, backend=b, device=dev,
                                  inj_spec=InjectionSpec(**slot_fault), **kw)
                out, rep, _, _, events = serve(srv, lag, f"{b} slot fault")
                want = (SERVE_FAULT_TICK, "commit" if lag == 1
                        else "deferred", "TDC", [1])
                check(events == [want] and len(rep.completed) == 8
                      and (rep.rollbacks == 1 if lag > 1
                           else rep.retries >= 1 and rep.rollbacks == 0)
                      and all(list(r.tokens) == clean[lag][r.rid]
                              for r in out),
                      f"{arch}: {b} slot fault at lag {lag}: events "
                      f"{events}, retries {rep.retries}, rollbacks "
                      f"{rep.rollbacks}, or a stream differs")
                del srv
        if is_moe:
            # the abft fault's target: element 5 of the first admission's
            # checksum block, logit (0, 5) of the first prompt (packs of one)
            first = min(requests(), key=lambda r: (r.arrival, r.rid))
            lg, _ = servers["abft"].model.prefill(params, {
                "tokens": torch.from_numpy(first.prompt[None]).to(dev)},
                max_len)
            v5 = float(lg.float()[0, 5].cpu())
            del lg
            nan_case = 1.0 <= abs(v5) < 2.0
            print(f"  abft admission target: clean logit (0, 5) of request "
                  f"{first.rid} = {v5!r}: bit 30 makes "
                  f"{'a NaN, uncorrectable (F3)' if nan_case else 'an outlier the guard corrects'}",
                  flush=True)
            abft_want = ([(0, "prefill", "TDC", [0])] if nan_case
                         else [(0, "prefill", "abft_corrected", [0])])
            for b, spec, want in (
                    ("sequential", dict(leaf_idx=0, flat_idx=7,
                                        bit=BF16_EXP_BIT, step=0, replica=1,
                                        target="prefill"),
                     [(0, "prefill", "TDC", [0])]),
                    ("abft", dict(leaf_idx=0, flat_idx=5, bit=30, step=0,
                                  replica=0, target="prefill_kernel"),
                     abft_want)):
                srv = make_server(rc, backend=b, device=dev,
                                  inj_spec=InjectionSpec(**spec), **kw)
                out, rep, _, _, events = serve(srv, 1, f"{b} admission fault")
                retried = b == "sequential" or nan_case
                check(events == want and len(rep.completed) == 8
                      and rep.prefill_retries == retried
                      and all(list(r.tokens) == clean[1][r.rid] for r in out),
                      f"{arch}: {b} admission fault: events {events}, "
                      f"prefill retries {rep.prefill_retries}")
                del srv
            packed = {b: make_server(rc, backend=b, device=dev)
                      for b in ("sequential", "fused")}
            for traffic, lag in ((requests, SERVE_LAG), (burst, 1),
                                 (burst, SERVE_LAG)):
                (out, rep, _, _, _), (fout, frep, _, _, _) = (
                    serve(packed[b], lag, f"{b} default max_pack "
                          f"{traffic.__name__}", traffic)
                    for b in ("sequential", "fused"))
                check(not rep.detections and not frep.detections
                      and len(rep.completed) == len(frep.completed) == 8
                      and (traffic is requests or rep.prefill_packs < 8)
                      and {r.rid: list(r.tokens) for r in out}
                      == {r.rid: list(r.tokens) for r in fout},
                      f"{arch}: default max_pack, {traffic.__name__} at lag "
                      f"{lag}: {rep.prefill_packs} packs, events "
                      f"{rep.detections} {frep.detections}, or fused's "
                      f"streams differ from sequential's")
            del packed
        if cfg.window_size:
            ring_rows_check(kfp, servers["hybrid"].model, max_len)
        del servers, params
        _free()
        torch.cuda.empty_cache()
        check(sum(k2_shapes.values()) == totals[arch]["flash_attention"],
              f"{arch}: K2 shapes {k2_shapes} miss launches")
        entries += k2_entries(kfa, cfg, k2_shapes, f"{arch}_serve")
        print(f"family serve: {arch} at {cfg.num_layers} layers took "
              f"{time.time() - t_model:.1f} s", flush=True)
    print(f"family serve phase took {time.time() - t_phase:.1f} s",
          flush=True)
    return totals, entries


def ring_rows_check(kfp, model, max_len: int) -> None:
    """K1's ring rows (hybrid's resident baseline of a windowed family) on
    a seeded serve state of the model's layout, slots at positions below,
    at and past the window: one launch, h1/h2/absmax bitwise equal to the
    plain leaf walk; device time beside the bound of the live words read
    once."""
    from repro_torch.core.fingerprint import slot_rows_fingerprint
    from repro_torch.tree import leaves, tree_map

    dev = torch.device("cuda")
    cfg, W = model.cfg, model.cfg.window_size
    gen = torch.Generator(device=dev).manual_seed(17)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                           device=dev).to(t.dtype),
                     model.init_cache(SERVE_SLOTS, max_len))
    pos = torch.tensor([0, W - 1, W, 2 * W + 5], device=dev)
    tok = torch.arange(SERVE_SLOTS, device=dev)[:, None]
    kw = {"roles": model.cache_roles(), "axes": model.slot_axes(),
          "window": W}
    before = kfp.launch_count.n
    got = slot_rows_fingerprint(cache, pos, tok, **kw)
    check(kfp.launch_count.n == before + 1, "K1 ring rows: not one launch")
    want = slot_rows_fingerprint(tree_map(lambda t: t.cpu(), cache),
                                 pos.cpu(), tok.cpu(), **kw)
    check(torch.equal(got[:2].cpu(), want[:2])
          and got[3].item() == want[3].item(),
          f"K1 ring rows differ from the plain version: {got} vs {want}")
    ms = device_ms(lambda: slot_rows_fingerprint(cache, pos, tok, **kw), 50)
    T = min(W, max_len)
    live = sum(min(int(p), T) - (1 if int(p) >= T else 0)
               for p in pos.tolist())
    ring_bytes = sum(t.element_size() * t[0, 0, 0].numel() * t.shape[0]
                     for t in leaves(cache) if t.dim() == 5) * live
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(cache)
                      if t.dim() != 5)
    b_ms, b_by = bound(ring_bytes + state_bytes + 8 * SERVE_SLOTS + 16, 0)
    print(f"K1 ring rows on {cfg.name}'s serve state ({SERVE_SLOTS} slots, "
          f"pos {pos.tolist()}, window {W}): h1/h2/absmax bitwise equal to "
          f"the plain version, one launch, device {ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}: live ring rows and the recurrent states "
          f"read once)", flush=True)


FAMILY_TRAIN_STEPS = 4
# (arch, layers kept or None, optimizer): full width, seeded weights, f32
# masters and bf16 compute, B=4 x 256 tokens (internvl2 behind 256 stub patch
# embeddings, seamless's encoder over 1,024 stub frames). Each family keeps
# one depth and one optimizer under all five backends. Sequential and fused
# hold the old and the candidate {params, opt} of two replicas and their
# grads (~56 B per parameter under adamw, ~40 under sgdm), so depth is cut,
# never a width, and only as far as fused's peak needs; sgdm where even the
# shallowest depth would not fit under adamw (PERF.md §4).
# depths cut to fit beside a dual run (PERF.md section 4); since the
# elastic phases, for the script's time, internvl2-2b 1 (8, 4, then 2) and
# seamless-m4t-medium 1 + 1 (12 + 12, 6 + 6, then 3 + 3)
# xlstm-125m trains on 64 tokens a sequence (256 before the remat phases;
# its sLSTM token loop, forward and backward, was 151.3 s of the phase at
# 256, for the script's time: PERF.md section 4)
FAMILY_TRAIN_SEQ = {"xlstm-125m": 64}
FAMILY_TRAIN_CASES = (("phi3.5-moe-42b-a6.6b", 1, "sgdm"),
                      ("recurrentgemma-2b", 3, "sgdm"),
                      ("internvl2-2b", 1, "adamw"),
                      ("xlstm-125m", 2, "adamw"),
                      ("seamless-m4t-medium", 1, "adamw"))
FAMILY_TRAIN_ABFT_MISS = ("phi3.5-moe-42b-a6.6b",)   # pure abft's miss shown
FAMILY_TRAIN_BACKENDS = ("none", "sequential", "fused", "abft", "hybrid")


def family_train_k1(kfp, tree, what: str) -> dict:
    """K1 in place on one family training tree against its plain versions
    (`k1_tree_values`), one host launch call per call, its device time
    (profiler) and its time per call by CUDA events (which includes the
    host's build of the leaf table), the plain leaf walk's, and the byte
    bound."""
    from repro_torch.core.fingerprint import pytree_fingerprint_fused
    from repro_torch.tree import leaves
    ds, rows, n = k1_tree_values(kfp, tree, what)
    calls, ran, _ = device_launches(lambda: pytree_fingerprint_fused(tree),
                                    iters=5)
    check(calls == 1 and ran <= 1, f"K1 on {what}: {calls} launch calls and "
          f"{ran} device kernels per call")
    table = kfp.leaf_table(leaves(tree))
    dev_ms = device_ms(lambda: pytree_fingerprint_fused(tree), 10)
    ms = cuda_ms(lambda: pytree_fingerprint_fused(tree), 10)
    plain_ms = cuda_ms(lambda: kfp.fingerprint_leaves_plain(table), 1,
                       warmup=1)
    b_ms, b_by = bound(4 * n + 16, 0)
    print(f"  K1 in place on {what}: {rows} leaves, {n} words, one launch "
          f"call per call, h1/h2/absmax bitwise equal to pack + plain and to "
          f"the plain leaf walk, |ds|={ds:.3e}; device {dev_ms:.4f} ms "
          f"({4 * n / dev_ms / 1e9:.3f} TB/s), per call {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"rows": rows, "words": n, "ms": dev_ms, "call_ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms}


def phase_family_train(kfp) -> int:
    """Slice 10: protected training of the moe, hybrid, vlm, ssm and audio
    families (FAMILY_TRAIN_CASES) at full width, 4 steps of 4 x 256 tokens
    each, L3 with FSC and a validated checkpoint every 2 on the device tier,
    `attention_impl="xla"` (K2 has no backward, in either package). Per
    family: clean runs under none, sequential, fused, abft and hybrid (0
    detections; abft's, hybrid's and sequential's losses and final per-leaf
    fingerprints bitwise equal to none's; fused within FUSED_LOSS_RTOL of
    sequential and its step-0 grads within FUSED_GRAD_GAP of the unbatched
    step's; K1's launches equal to the code's count; peak memory under the
    card's), a grads fault (leaf 0 element 5 bit 20, replica 1, step 3)
    under sequential and under fused, detected at the commit, restored from
    step 2 and ending bitwise equal to the same backend's clean run, and a
    resident parameter bit (params leaf 0 element 5 bit 20) flipped in
    place after step 2's commit, which hybrid's entry check at step 2
    catches and restores, ending bitwise equal to hybrid's clean run (and,
    for FAMILY_TRAIN_ABFT_MISS, which pure abft misses). Printed per family
    and backend: ms/step (wall / steps of the L3 run), peak memory, K1
    launches, host launch calls of one profiled protected step, seconds
    per device-tier save and per restore. K1 on the family's grads and
    {params, opt} trees against its plain version, timed, with its byte
    bound. Returns K1's launches in the clean L3 runs."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                     get_config)
    from repro_torch.core.engine import replica_view
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_trainer
    from repro_torch.tree import leaves

    t_phase = time.time()
    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    steps = FAMILY_TRAIN_STEPS
    l3 = SedarConfig(level=3, replication="sequential", validate_interval=1,
                     param_validate_interval=2, checkpoint_interval=2,
                     ckpt_tiers="device")
    grads_spec = InjectionSpec(target="grads", leaf_idx=0, flat_idx=5,
                               bit=20, step=3, replica=1)
    launches = 0
    root = tempfile.mkdtemp(prefix="sedar_family_train_")
    try:
        for arch, depth, opt in FAMILY_TRAIN_CASES:
            t_fam = time.time()
            cfg = dataclasses.replace(get_config(arch), attention_impl="xla",
                                      remat=PINNED_REMAT)
            cfg = cut_depth(cfg, depth)
            seq = FAMILY_TRAIN_SEQ.get(arch, TRAIN_SEQ)
            tcfg = TrainConfig(global_batch=BATCH, seq_len=seq,
                               steps=steps, warmup_steps=2, optimizer=opt)

            def trainer(name, backend, spec=None):
                rc = RunConfig(model=cfg, train=tcfg, sedar=dataclasses.replace(
                    l3, replication=backend))
                return make_trainer(rc, os.path.join(root, arch, name),
                                    inj_spec=spec, notify=lambda e: None,
                                    device=dev)

            init = trainer("init", "none")
            t0 = time.time()
            state = init.init_state(seed=0)
            torch.cuda.synchronize()
            n_params = sum(p.numel() for p in leaves(state["params"]))
            n_fp = len(leaves({"params": state["params"],
                               "opt": state["opt"]}))
            del state

            def make_state():
                return init.init_state(seed=0)

            front = (f" behind {cfg.frontend_seq} {cfg.frontend} embeddings"
                     if cfg.frontend else "")
            print(f"family train: {arch} [{cfg.family}] {cfg.num_layers}L"
                  f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
                  f" d={cfg.d_model} V={cfg.vocab_size}, {n_params} f32 "
                  f"params (seeded init {time.time() - t0:.2f} s), {opt}, "
                  f"{n_fp} {{params, opt}} leaves, batch {BATCH} x "
                  f"{seq} tokens{front}, {steps} steps, L3 (FSC and "
                  f"checkpoint every 2, device tier)", flush=True)

            def run(tr, state=None, n=steps):
                """(dual, report, peak GiB, K1 launches, ms/step)."""
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = kfp.launch_count.n
                d, r = tr.run(n, dual=state if state is not None else
                              tr.engine.executor.init_dual(make_state()))
                torch.cuda.synchronize()
                return (d, r, torch.cuda.max_memory_allocated() / 2 ** 30,
                        kfp.launch_count.n - before,
                        r.wall_s * 1e3 / max(r.steps_completed, 1))

            # warm-up: one unprotected step, so the first timed run does
            # not carry cuBLAS's and the allocator's first calls
            run(trainer("warm", "none"), n=1)
            _free()
            clean, row = {}, {}
            for backend in FAMILY_TRAIN_BACKENDS:
                tr = trainer(f"{backend}_clean", backend)
                saves: list = []
                _timed_sync(tr.recovery.tiers.device, "save", saves)
                d, r, peak, n, ms = run(tr)
                want = _l3_k1_launches(backend, n_fp, l3, steps)
                print(f"  {backend} clean: {r.summary()}; losses "
                      f"{r.losses}; {ms:.2f} ms/step; peak {peak:.2f} GiB "
                      f"of {total:.2f}; K1 launches {n} (the code's count "
                      f"{want}); device-tier saves (s) "
                      f"{[round(x, 4) for x in saves]}", flush=True)
                check(not r.detections and not r.stopped
                      and r.steps_completed == steps
                      and r.checkpoints == [2, 4]
                      and len(r.losses) == steps
                      and all(np.isfinite(r.losses)),
                      f"{arch}: clean {backend} training run: {r.summary()}")
                check(n == want, f"{arch}: {backend} K1 launched {n} times, "
                      f"not {want}")
                check(peak < total, f"{arch}: {backend} peak {peak:.2f} GiB")
                launches += n
                clean[backend] = r
                row[backend] = {"ms": ms, "peak": peak, "saves": saves}
                if backend == "none":
                    # K1 on the state after 4 steps and on the grads of the
                    # next step's batch at that state
                    st = tr.engine.executor.primary(d)
                    k1_state = family_train_k1(
                        kfp, {"params": st["params"], "opt": st["opt"]},
                        f"{arch}'s params + {opt} state after {steps} steps")
                    _, grads = tr.loss_and_grads(st["params"],
                                                 tr.batch(steps))
                    k1_grads = family_train_k1(kfp, grads,
                                               f"{arch}'s grads")
                    del st, grads
                del d, tr
                _free()
            none = clean["none"]
            for backend in ("sequential", "abft", "hybrid"):
                r = clean[backend]
                check(r.losses == none.losses and np.array_equal(
                          r.final_state_fp[:, :2], none.final_state_fp[:, :2]),
                      f"{arch}: {backend}'s losses or final state are not "
                      f"bitwise equal to none's: {r.losses} vs {none.losses}")
            seq, fus = clean["sequential"], clean["fused"]
            rl = max(abs(a - b) / abs(b) for a, b in
                     zip(fus.losses, seq.losses))
            print(f"  abft, hybrid and sequential losses and final per-leaf "
                  f"fingerprints bitwise equal to none's; fused's losses "
                  f"{rl:.3e} relative from sequential's (limit "
                  f"{FUSED_LOSS_RTOL:g}), bitwise equal: {rl == 0 and np.array_equal(fus.final_state_fp[:, :2], seq.final_state_fp[:, :2])}",
                  flush=True)
            check(rl <= FUSED_LOSS_RTOL, f"{arch}: fused losses {rl:.3e} "
                  f"(relative) from sequential's")

            # fused's step-0 grads against the unbatched step's
            fz = trainer("fused_grads", "fused")
            dz = fz.engine.executor.init_dual(make_state())
            batch = fz.batch(0)
            _, sg = fz.loss_and_grads_stacked(dz["s"]["params"], batch)
            del dz
            g0 = replica_view(sg, 0)
            eq = all(torch.equal(a, b) for a, b in zip(
                leaves(g0), leaves(replica_view(sg, 1))))
            params = make_state()["params"]
            _, single = fz.loss_and_grads(params, batch)
            del params
            rel = [float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(leaves(g0), leaves(single))]
            wi = int(np.argmax(rel))
            print(f"  fused step-0 grads: the replicas' slices bitwise equal "
                  f"{eq}; against the unbatched step: "
                  f"{sum(x == 0 for x in rel)} of {len(rel)} leaves bitwise "
                  f"equal, largest |diff| / max|g| {rel[wi]:.3e} (leaf {wi};"
                  f" limit {FUSED_GRAD_GAP:g})", flush=True)
            check(eq and rel[wi] <= FUSED_GRAD_GAP,
                  f"{arch}: fused grads off the unbatched step's")
            del sg, g0, single, fz
            _free()

            # a grads fault under sequential and under fused
            for backend in ("sequential", "fused"):
                tr = trainer(f"{backend}_fault", backend, grads_spec)
                rest_s: list = []
                _timed_sync(tr.recovery, "restore", rest_s)
                _, r, _, _, ms = run(tr)
                events = [(e.step, e.boundary, e.effect)
                          for e in r.detections]
                recs = [(x["kind"], x["step"], x["rollbacks"])
                        for x in r.recoveries]
                c = clean[backend]
                same = (np.array_equal(r.final_state_fp[:, :2],
                                       c.final_state_fp[:, :2])
                        and r.losses == c.losses)
                print(f"  {backend} grads fault (leaf 0 element 5 bit 20, "
                      f"replica 1, step 3): events {events}, recoveries "
                      f"{recs}, restore {[round(x, 4) for x in rest_s]} s, "
                      f"{ms:.2f} ms/step; losses and final per-leaf "
                      f"fingerprints bitwise equal to {backend}'s clean run: "
                      f"{same}", flush=True)
                check(events == [(3, "commit", "TDC")]
                      and recs == [("restore", 2, 1)] and same
                      and r.steps_completed == steps,
                      f"{arch}: {backend} grads fault not recovered to the "
                      f"clean run")
                row[backend]["restore"] = rest_s
                del tr
                _free()

            # a resident parameter bit flipped in place after step 2
            for backend in ("hybrid",) + (
                    ("abft",) if arch in FAMILY_TRAIN_ABFT_MISS else ()):
                tr = trainer(f"{backend}_rest", backend)
                rest_s = []
                _timed_sync(tr.recovery, "restore", rest_s)
                d, r1, _, _, _ = run(tr, n=2)
                leaf = leaves(tr.engine.executor.primary(d)["params"])[0]
                leaf.view(-1)[5:6].view(torch.int32).bitwise_xor_(1 << 20)
                _, r2, _, _, _ = run(tr, state=d)
                del d, leaf
                c = clean[backend]
                events = [(e.step, e.boundary, e.effect)
                          for e in r2.detections]
                recs = [(x["kind"], x["step"], x["rollbacks"])
                        for x in r2.recoveries]
                same = (np.array_equal(r2.final_state_fp[:, :2],
                                       c.final_state_fp[:, :2])
                        and r1.losses + r2.losses == c.losses)
                print(f"  {backend}, params leaf 0 element 5 bit 20 flipped "
                      f"at rest after step 2: events {events}, recoveries "
                      f"{recs}, restore {[round(x, 4) for x in rest_s]} s; "
                      f"final state and losses bitwise equal to {backend}'s "
                      f"clean run: {same}", flush=True)
                if backend == "hybrid":
                    check(events == [(2, "validate", "FSC")]
                          and recs == [("restore", 2, 1)] and same,
                          f"{arch}: hybrid did not catch and recover the "
                          f"at-rest fault")
                    row[backend]["restore"] = rest_s
                else:
                    check(not r2.detections and not same,
                          f"{arch}: pure abft should miss the at-rest fault")
                del tr
                _free()

            # one protected step (no boundary) per backend, profiled
            for backend in FAMILY_TRAIN_BACKENDS:
                tr = trainer(f"{backend}_profile", backend)
                d = tr.engine.executor.init_dual(make_state())
                b3 = (3, tr.batch(3))
                tr.engine.run_protected_step(d, b3, 3)       # warm
                wall_ms, busy_ms, ran, _, calls = device_profile(
                    lambda: tr.engine.run_protected_step(d, b3, 3))
                row[backend]["calls"] = calls
                row[backend]["busy"] = busy_ms / wall_ms
                del d, tr
                _free()
            print(f"  {arch} per backend (ms/step of the clean L3 run, one "
                  f"turn; peak GiB; host launch calls of one protected step, "
                  f"profiler on; device busy share there): " + "; ".join(
                      f"{b} {v['ms']:.2f} ms, {v['peak']:.2f} GiB, "
                      f"{v.get('calls', 'not profiled')} calls, "
                      f"{100 * v.get('busy', float('nan')):.1f}% busy"
                      for b, v in row.items()), flush=True)
            del init, clean
            _free()
            torch.cuda.empty_cache()
            print(f"family train: {arch} took {time.time() - t_fam:.1f} s; "
                  f"K1 {k1_grads['ms']:.4f} ms on the grads ({k1_grads['rows']}"
                  f" leaves), {k1_state['ms']:.4f} ms on params + opt "
                  f"({k1_state['rows']} leaves)", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"family train phase took {time.time() - t_phase:.1f} s",
          flush=True)
    return launches


# (arch, B, H, KV, S, hd, window): the f32 body's wide head dims at the
# families' prefill shapes (internvl2-2b: 256 patches + 256 tokens)
F32_WIDE_CASES = (("internvl2-2b", 4, 16, 8, 512, 128, 0),
                  ("recurrentgemma-2b", 2, 10, 1, 4096, 256, 2048))
F32_TOL = 1e-5      # atol and rtol of the f32 body against its plain version


def _f32_check(what: str, got, again, want) -> float:
    diff = (got - want).abs()
    err = float(diff.max())
    over = float((diff - F32_TOL * want.abs()).max())
    check(bool(torch.isfinite(got).all()), f"{what} non-finite")
    check(over <= F32_TOL, f"{what} off plain beyond atol {F32_TOL} + rtol "
          f"{F32_TOL} (max abs err {err})")
    check(torch.equal(got, again), f"{what} not bitwise repeatable")
    return err


def phase_f32_wide(kab, kfa, report) -> tuple:
    """K2 f32 and K4 (one true-f32 body) at hd 128 (internvl2-2b's prefill,
    B=4 H=16/8 S=512 causal) and hd 256 (recurrentgemma-2b's, B=2 H=10/1
    S=4096, window 2048) against their plain versions within atol/rtol
    1e-5, two launches bitwise equal, K4's verdict clean and on a bit-23
    flip of its largest output; each timed beside its plain version and
    SDPA f32 on the MATH backend (with the window as a boolean mask), with
    its bound at the f32 rate and ptxas's registers and spills. K4 has no
    model path in either package: its launches are `abft_flash_attention`
    API calls, one per attention layer of the family. Returns (the K2 f32
    entries by head dim, the K4 entries)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.abft.ref import attention_checksum_encode, attention_verify
    from repro_torch.core.injection import InjectionSpec, make_kernel_fault
    dev = torch.device("cuda")
    k2, k4 = {}, []
    for arch, B, H, KV, S, hd, W in F32_WIDE_CASES:
        gen = torch.Generator(device=dev).manual_seed(S + hd)
        # model layout (B, S, heads, hd) viewed as (B, heads, S, hd)
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev
                               ).transpose(1, 2) for n in (H, KV, KV))
        v_aug = attention_checksum_encode(v)
        pos = torch.arange(S, device=dev)
        mask = ((pos[:, None] >= pos[None, :])
                & (pos[:, None] - pos[None, :] < (W or S)))
        pairs = _window_pairs(S, W)
        tag = f"hd{hd}_{arch}"
        for name, fn, plain, vv, width in (
                ("K2 f32", lambda: kfa.flash_attention_fwd(
                    q, k, v, causal=True, window=W),
                 lambda: kfa.flash_attention_plain(q, k, v, causal=True,
                                                   window=W), v, hd),
                ("K4", lambda: kab.flash_attention_ck(
                    q, k, v_aug, causal=True, window=W),
                 lambda: kfa.flash_attention_plain(q, k, v_aug, causal=True,
                                                   window=W), v_aug, hd + 1)):
            got, again, want = fn(), fn(), plain()
            err = _f32_check(f"{name} {tag}", got, again, want)
            ms = device_ms(fn, 10)
            plain_ms = device_ms(plain, 3)
            # the same by CUDA events, which no missing profiler record
            # can shorten (the host's gaps included)
            plain_ev = cuda_ms(plain, 3)
            with sdpa_kernel(SDPBackend.MATH):
                lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, vv, attn_mask=mask, enable_gqa=True), 3)
            flops = 2.0 * B * H * pairs * (hd + width)     # QK^T and PV
            nbytes = 4.0 * B * S * (H * hd + KV * hd + KV * width
                                    + H * width)
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS_PER_S)
            key = f"flash_fwd_f32<{hd},{int(name == 'K4')}>"
            regs, spill, _ = report.get(key, (None, None, None))
            smem = ((5 if hd <= 128 else 3) * 64 * (hd + 4) + 64 * 68) * 4
            verdict = ""
            if name == "K4":
                _, rep = attention_verify(got, S)
                flat = int(got[..., :hd].abs().argmax())
                spec = InjectionSpec(leaf_idx=0, flat_idx=flat // hd * (hd + 1)
                                     + flat % hd, bit=23, step=0,
                                     target="kernel")
                _, frep = attention_verify(
                    make_kernel_fault(spec, step=0, armed=True)(got), S)
                check(not bool(rep.detected), f"clean K4 detected at {tag}")
                check(bool(frep.detected) and bool(frep.uncorrectable),
                      f"K4's bit-23 fault not flagged at {tag}")
                verdict = (", clean verify detected False, bit-23 flip of "
                           "the largest output detected True, "
                           "uncorrectable True")
            print(f"{name} {tag} (B={B} H={H}/{KV} S={S} window={W}): max abs "
                  f"err {err:.3e} vs plain (f32), two launches bitwise "
                  f"equal{verdict}; device {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms (by CUDA events {plain_ev:.4f} ms), sdpa f32 MATH "
                  f"{lib_ms:.4f} ms; bound {b_ms:.5f} ms "
                  f"({b_by}, f32 rate), {flops / ms / 1e9:.2f} TFLOP/s; "
                  f"{key}: {regs} registers, {spill} bytes spilled, {smem} "
                  f"bytes of dynamic shared memory per block", flush=True)
            entry = {"route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            if name == "K2 f32":
                k2[hd] = dict(entry, name=f"flash_attention_f32_{tag}",
                              replaces="src/repro/kernels/flash_attention.py:33")
                continue
            # the API once per attention layer of the family
            layers = 24 if hd == 128 else 8
            kab.flash_ck_launch_count.reset()
            for _ in range(layers):
                _, rep = kab.abft_flash_attention(q, k, v, causal=True,
                                                  window=W)
                check(not bool(rep.detected), f"K4 API detected at {tag}")
            k4.append(dict(entry, name=f"abft_flash_attention_{tag}",
                           replaces="src/repro/abft/kernels.py:122",
                           launches=kab.flash_ck_launch_count.n))
        del q, k, v, v_aug, mask
        torch.cuda.empty_cache()
    return k2, k4


# (arch, batch, prompt tokens): the f32 generate() path through the f32 K2
# body at hd 128 (internvl2-2b, with 256 stub patch embeddings) and hd 256
# (recurrentgemma-2b, window 2048); full width, seeded f32 weights
F32_GENERATE_CASES = (("internvl2-2b", 4, 256), ("recurrentgemma-2b", 2, 4096))
F32_GENERATE_STEPS = 8
F32_LOGITS_RTOL = 1e-4   # first-token logits, pallas vs xla f32, of max |x|


def phase_f32_generate(kfp, kfa) -> dict:
    """Protected generate() in f32 compute (`dtype="float32"`) with
    `attention_impl="pallas"`, so the prefill runs K2's f32 body at hd 128
    and 256: 8 greedy tokens under none and sequential (equal streams, no
    detection on the clean runs, K2's f32 launches counted by shape), and
    the first token's logits against the same model with
    `attention_impl="xla"` in f32 (both compute the same f32 attention):
    max |difference| within F32_LOGITS_RTOL of the logits' max |value|,
    the same greedy token. Returns {head dim: K2 f32 launches}."""
    import dataclasses

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.policy import make_server
    from repro_torch.models import build_model, transformer as tfm
    from repro_torch.tree import leaves

    t_phase = time.time()
    dev = torch.device("cuda")
    launches = {}
    for arch, B, S in F32_GENERATE_CASES:
        cfg = dataclasses.replace(get_config(arch), attention_impl="pallas",
                                  dtype="float32")
        rng = np.random.RandomState(7)
        prompt = {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (B, S))).to(dev)}
        if cfg.frontend:
            prompt["frontend_embeds"] = 0.1 * torch.from_numpy(
                rng.standard_normal((B, cfg.frontend_seq, cfg.frontend_dim)
                                    ).astype(np.float32)).to(dev)
        P = cfg.frontend_seq if cfg.family == "vlm" else 0
        attn_layers = (sum(k == "attention" for k in cfg.block_pattern)
                       * (cfg.num_layers // len(cfg.block_pattern))
                       + sum(k == "attention" for k in tfm.pattern_tail(cfg))
                       if cfg.block_pattern else cfg.num_layers)
        servers = {b: make_server(RunConfig(model=cfg), backend=b, device=dev)
                   for b in ("none", "sequential")}
        params = servers["none"].model.init(seed=0)
        n_params = sum(p.numel() for p in leaves(params))
        print(f"f32 generate: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
              f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
              f"window={cfg.window_size}, {n_params / 1e9:.2f}B f32 params, "
              f"f32 compute, B={B} prompt={S}"
              f"{f' + {P} patches' if P else ''}, {F32_GENERATE_STEPS} "
              f"tokens", flush=True)
        servers["none"].generate(params, prompt, steps=2)      # warm-up
        runs = {b: _family_run(kfp, kfa, srv, params, prompt, f"{b} f32",
                               steps=F32_GENERATE_STEPS)
                for b, srv in servers.items()}
        shapes = dict(kfa.launch_count.shapes)
        key = (B, cfg.num_heads, cfg.num_kv_heads, S + P, S + P,
               cfg.head_dim, 1, cfg.window_size, torch.float32)
        toks = runs["none"][0]
        for b, (t, rep, counts, _) in runs.items():
            check(np.array_equal(t, toks), f"f32 {arch}: {b} tokens differ "
                  f"from the unprotected run")
            check(not rep.detections and not rep.stopped,
                  f"f32 {arch}: clean {b} run detected "
                  f"{[str(e) for e in rep.detections]}")
            check(counts["flash_attention"] == attn_layers,
                  f"f32 {arch}: K2 launched {counts['flash_attention']} != "
                  f"{attn_layers} times under {b}")
        # the counts by shape are the last run's (each run resets them)
        check(shapes == {key: attn_layers},
              f"f32 {arch}: K2 launches by shape {shapes}, not "
              f"{attn_layers} f32 launches at {key}")
        launches[cfg.head_dim] = (runs["none"][2]["flash_attention"]
                                  + runs["sequential"][2]["flash_attention"])
        xla = build_model(dataclasses.replace(cfg, attention_impl="xla"), dev)
        with torch.no_grad():
            got, _ = servers["none"].model.prefill(params, prompt, S + P + 8)
            want, _ = xla.prefill(params, prompt, S + P + 8)
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        print(f"  f32 {arch}: K2 f32 launches {launches[cfg.head_dim]} "
              f"(by shape {shapes}); first-token logits pallas vs xla: max "
              f"abs diff {err:.3e} of max |logit| {scale:.3e} "
              f"({err / scale:.3e}), greedy tokens equal {same}", flush=True)
        check(err <= F32_LOGITS_RTOL * scale and same,
              f"f32 {arch}: pallas logits off xla by {err} (max {scale})")
        del servers, params, xla, got, want, runs
        _free()
    print(f"f32 generate phase took {time.time() - t_phase:.1f} s",
          flush=True)
    return launches


K1_LANES = (1, 2, 8)


def k1_lanes_entry(kfp, tree, what: str) -> dict:
    """K1's lanes (`pytree_fingerprint_lanes`, one launch over the leaves in
    place) at L = 1, 2 and 8 against the plain lanes of the packed words:
    h1, h2 and absmax of every lane bitwise equal; per call by CUDA events
    against the byte bound, the plain version over the lane table beside
    it. Returns the kernels-line entry at L = 1, the pod path's lanes on
    one card (one data shard)."""
    from repro_torch.core.fingerprint import (pack_tree_u32,
                                              pytree_fingerprint_lanes)
    from repro_torch.tree import leaves
    u = pack_tree_u32(tree)
    n = u.numel()
    entry = None
    for L in K1_LANES:
        got = pytree_fingerprint_lanes(tree, L)
        width = -(-n // L)
        want = torch.stack([kfp.fingerprint_plain(torch.cat([
            u[i * width:min((i + 1) * width, n)],
            u.new_zeros(max(0, (i + 1) * width - max(n, i * width)))]))
            for i in range(L)])
        check(torch.equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]]),
              f"K1 lanes L={L} on {what}: h1/h2/absmax differ from plain")
        table = kfp.lane_table(leaves(tree), L)
        ms = cuda_ms(lambda: pytree_fingerprint_lanes(tree, L), 20)
        plain_ms = cuda_ms(lambda: kfp.fingerprint_lanes_plain(table, L), 1,
                           warmup=1)
        b_ms, b_by = bound(4.0 * n + 16 * L, 0)
        print(f"K1 lanes L={L} on {what}: {len(table)} table rows, {n} "
              f"words, h1/h2/absmax of every lane bitwise equal to plain; "
              f"per call {ms:.4f} ms ({4 * n / ms / 1e9:.3f} TB/s), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        if L == 1:
            entry = {"name": "fingerprint_lanes", "route": "cuda",
                     "source": "src/repro_torch/csrc/fingerprint.cu",
                     "replaces": "src/repro/kernels/fingerprint.py:51",
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del u
    return entry


POD_STEPS = TRAIN_STEPS
POD_TIMEOUT_S = 600


def pod_rank(rank: int, backend: str, mesh_cfg, runs: list,
             root: str) -> dict:
    """One rank of phase_pod_train (spawned by `launch/mesh.py::spawn`):
    the training launcher's rank, `launch/train.py::mesh_rank`, on
    qwen2-0.5b at full width (seeded init and data), once per run of
    `runs` = [(name, sedar kwargs, injection kwargs or None)], each under
    sync-debug "error" (a device read outside `hostsync` fails it).
    mesh_rank's report gives ms/step, peak memory, K1 launches, host reads
    and collectives; around it this rank counts the -0.0 the state holds
    when a vote repair's broadcast lands and the broadcast's seconds.
    Then the gloo probes."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import RunConfig, SedarConfig, TrainConfig, get_config
    from repro_torch.core import hostsync
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import mesh_rank
    from repro_torch.runtime import train as rtrain
    from repro_torch.tree import leaves

    # the -0.0 the state holds when the majority's broadcast lands (the
    # reference's masked psum would make each +0.0), and the broadcast's
    # host seconds (the gloo calls wait for each leaf's staging through
    # host memory): the vote trainer's broadcaster, wrapped in this process
    at_repair = []
    make_broadcaster = rtrain.make_pod_broadcaster

    def counting_broadcaster(mesh):
        bcast = make_broadcaster(mesh)

        def from_src(src):
            def run(tree):
                n = sum(hostsync.read_int(
                    ((x == 0) & torch.signbit(x)).sum(),
                    label="negative_zeros")
                    for x in leaves(tree) if x.is_floating_point())
                t0 = time.perf_counter()
                out = bcast(src)(tree)
                at_repair.append((n, time.perf_counter() - t0))
                return out
            return run
        return from_src

    rtrain.make_pod_broadcaster = counting_broadcaster
    cfg = pinned(get_config("qwen2-0.5b"))
    out = {}
    for name, sedar_kw, spec_kw in runs:
        rc = RunConfig(model=cfg, mesh=mesh_cfg,
                       train=TrainConfig(global_batch=BATCH, seq_len=TRAIN_SEQ,
                                         steps=POD_STEPS, warmup_steps=2),
                       sedar=SedarConfig(level=3, replication=backend,
                                         **sedar_kw))
        torch.cuda.set_sync_debug_mode("error")
        try:
            rep = mesh_rank(rank, rc, mesh_cfg, os.path.join(root, name),
                            spec_kw and InjectionSpec(**spec_kw), "cuda")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[name] = dict(rep, negative_zeros_at_repair=list(at_repair))
        at_repair.clear()
        gc.collect()
        torch.cuda.empty_cache()
    out["pod"], out["data"] = rep["pod"], rep["data"]
    mesh = make_process_mesh(mesh_cfg)
    # gloo on CUDA tensors: the cost of one small all_reduce over the pod
    # group, whether the call returns before the device work queued ahead
    # of it has run, and whether gloo takes an all_gather
    x = torch.zeros(8, dtype=torch.int64, device="cuda")
    big = torch.randn(4096, 4096, device="cuda")
    for _ in range(3):
        with hostsync.collective("probe"):
            dist.all_reduce(x, group=mesh.pod_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        with hostsync.collective("probe"):
            dist.all_reduce(x, group=mesh.pod_group)
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    queued = cuda_ms(lambda: big @ big, 10, warmup=1) * 20
    for _ in range(20):
        big @ big
    t0 = time.perf_counter()
    with hostsync.collective("probe"):
        dist.all_reduce(x, group=mesh.pod_group)
    out["call_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    out["queued_ms"] = queued
    gathered = [torch.zeros_like(x) for _ in range(mesh.n_pods)]
    try:
        with hostsync.collective("probe"):
            dist.all_gather(gathered, x, group=mesh.pod_group)
        out["all_gather"] = "taken"
    except RuntimeError as e:
        out["all_gather"] = f"refused: {str(e).splitlines()[0][:160]}"
    return out


def phase_pod_train(kfp, seq_losses, seq_final) -> int:
    """Slice 11, the mesh backends on one card: qwen2-0.5b at full width
    (the training cell: batch 4 x 256 tokens, adamw, 6 steps, L3), each
    replica a process of its own over gloo (`launch/mesh.py`), every rank
    on this card and under sync-debug "error".
    pod, 2 ranks x 1 data shard, L3 every 2 on the device tier: a clean
    run at validate lag 4 (no `commit_compare` read) and a grads fault
    (leaf 0 element 5 bit 20, pod 1, step 3) at lag 1: one commit TDC at
    step 3 in lane 0 (host 0), restored from the device tier, ending
    bitwise equal to the clean run.
    vote, 3 ranks, FSC every 2, no checkpoint: a clean run, and a params
    fault (leaf 2 element 3 bit 30, pod 1, step 3) repaired forward by the
    majority's broadcast with 0 rollbacks, ending bitwise equal to the
    clean run.
    Every rank of a run ends on the same bits; the clean pod and vote runs
    end on the single-process sequential trainer's losses and state
    (`seq_losses`, `seq_final`: phase train's clean L3 run), bitwise.
    Prints ms/step, peak memory, K1 launches and host reads per rank, and
    the gloo probes. Returns K1's launches over the pod runs' ranks (the
    lane fingerprint of the grads is one of them every step)."""
    import shutil
    import tempfile

    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import spawn

    t_phase = time.time()
    _free()
    # the ranks are other processes: this one's cached blocks (phase
    # train's peak) must go back to the card first
    torch.cuda.empty_cache()
    print(f"pod phase: this process keeps "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved while "
          f"the ranks run", flush=True)
    root = tempfile.mkdtemp(prefix="sedar_pod_")
    l3 = dict(validate_interval=1, param_validate_interval=2,
              checkpoint_interval=2, ckpt_tiers="device", device_ring_slots=2)
    vote_kw = dict(validate_interval=1, param_validate_interval=2,
                   checkpoint_interval=100)
    grads_fault = dict(target="grads", leaf_idx=0, flat_idx=5, bit=20,
                       step=3, replica=1)
    params_fault = dict(target="params", leaf_idx=2, flat_idx=3, bit=30,
                        step=3, replica=1)
    try:
        t0 = time.time()
        pod = spawn(pod_rank, 2, "pod", MeshConfig(shape=(2, 1)),
                    [("clean", dict(l3, validate_lag=4), None),
                     ("fault", dict(l3, validate_lag=1), grads_fault)],
                    os.path.join(root, "pod"), timeout_s=POD_TIMEOUT_S)
        t_pod = time.time() - t0
        t0 = time.time()
        vote = spawn(pod_rank, 3, "vote", MeshConfig(shape=(3, 1)),
                     [("clean", vote_kw, None), ("fault", vote_kw,
                                                params_fault)],
                     os.path.join(root, "vote"), timeout_s=POD_TIMEOUT_S)
        t_vote = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for backend, reps, secs in (("pod", pod, t_pod), ("vote", vote, t_vote)):
        print(f"{backend}: {len(reps)} ranks on one card took {secs:.1f} s "
              f"(spawn, init and both runs)", flush=True)
        for r, rep in enumerate(reps):
            for name in ("clean", "fault"):
                x = rep[name]
                print(f"  {backend} rank {r} (pod {rep['pod']}) {name}: "
                      f"{x['summary']}; events {x['detections']}; "
                      f"recoveries {x['recoveries']}; (-0.0 in the state, "
                      f"broadcast seconds) at a vote repair "
                      f"{x['negative_zeros_at_repair']}; "
                      f"{x['ms_step']:.2f} "
                      f"ms/step, peak {x['peak_gib']:.2f} GiB, K1 launches "
                      f"{x['k1']}, host reads "
                      f"{x['reads']}, collectives {x['collectives']}",
                      flush=True)
            print(f"  {backend} rank {r} gloo: all_reduce of 8 int64 words "
                  f"over the pod group {rep['allreduce_ms']:.3f} ms per "
                  f"call; with {rep['queued_ms']:.1f} ms of device work "
                  f"queued ahead the call took {rep['call_ms']:.1f} ms; "
                  f"all_gather on CUDA tensors {rep['all_gather']}",
                  flush=True)
        for name in ("clean", "fault"):
            finals = [rep[name]["final_state_fp"] for rep in reps]
            check(all(np.array_equal(f, finals[0]) for f in finals),
                  f"{backend} {name}: the ranks' final states differ")
            check(all(rep[name]["losses"] == reps[0][name]["losses"]
                      for rep in reps),
                  f"{backend} {name}: the ranks' losses differ")
    for backend, reps in (("pod", pod), ("vote", vote)):
        clean = reps[0]["clean"]
        check(all(not rep["clean"]["detections"]
                  and rep["clean"]["steps"] == POD_STEPS for rep in reps),
              f"clean {backend} run: {clean['summary']}")
        check(np.array_equal(clean["final_state_fp"][:, :2],
                             np.asarray(seq_final)[:, :2])
              and clean["losses"] == list(seq_losses),
              f"clean {backend}: losses {clean['losses']} or state differ "
              f"from the sequential trainer's ({list(seq_losses)})")
        for rep in reps:
            f = rep["fault"]
            check(np.array_equal(f["final_state_fp"],
                                 rep["clean"]["final_state_fp"])
                  and f["losses"] == rep["clean"]["losses"]
                  and f["steps"] == POD_STEPS,
                  f"{backend}: the fault run does not end bitwise on the "
                  f"clean run: {f['summary']}")
    for rep in pod:
        check("commit_compare" not in rep["clean"]["reads"],
              f"clean lag-4 pod read commit_compare: {rep['clean']['reads']}")
        f = rep["fault"]
        check([(d["step"], d["boundary"], d["effect"], d["lanes"], d["hosts"])
               for d in f["detections"]] == [(3, "commit", "TDC", [0], [0])],
              f"pod fault events {f['detections']}")
        check([(r["kind"], r["step"], r["rollbacks"], r.get("tier"))
               for r in f["recoveries"]] == [("restore", 2, 1, "device")],
              f"pod fault recoveries {f['recoveries']}")
    for rep in vote:
        f = rep["fault"]
        check([(d["step"], d["boundary"], d["effect"])
               for d in f["detections"]] == [(4, "validate", "FSC")]
              and [(r["kind"], r["rollbacks"]) for r in f["recoveries"]]
              == [("vote_repair", 0)],
              f"vote fault: events {f['detections']}, recoveries "
              f"{f['recoveries']}")
    print(f"pod and vote: clean runs 0 detections, losses and final state "
          f"bitwise equal to the sequential trainer's; the pod grads fault "
          f"restored from the device tier and the vote params fault repaired "
          f"forward, both bitwise equal to the clean runs; pod phase took "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return sum(rep[name]["k1"] for rep in pod for name in ("clean", "fault"))


ELASTIC_SCHEDULE = dict(n_hosts=2, dark_host=1, dark_from=150.0,
                        dark_to=250.0)
ELASTIC_SCAN = 2
POD_ELASTIC_TIMEOUT_S = 600
# phase pod_elastic keeps 2 of qwen2-0.5b's 24 layers (full width). Memory
# forced a cut: at a checkpoint boundary a rank holds the step's input
# state, its output, the ring's older slot and the new slot's clone, 4 x
# 5.93 GB at full depth, and the four ranks share the card's 80 GB (they
# ran out of memory there on an NVIDIA H100 80GB HBM3). Time forced the
# rest: at 12 layers (3.78 GB a state) the phase took 151.1 s, most of it
# the 14 partner versions the ranks write, and the script 1,195.7 s against
# its 1,200 s limit; at 2 layers a state is 2.00 GB
POD_ELASTIC_LAYERS = 2


def _full_width_losses(rep) -> list:
    """The losses of an elastic run's full-width trajectory: the segments
    before the shrink, then those replayed from the regrow's anchor (the
    degraded segments in between are discarded)."""
    shrink, regrow = rep["remeshes"]
    segs = rep["segments"]
    pre = []
    for seg in segs:
        pre.append(seg)
        if seg["steps"] == shrink["trigger_step"]:
            break
    post = []
    for seg in reversed(segs):
        post.insert(0, seg)
        if seg["steps"] - len(seg["losses"]) == regrow["restore_step"]:
            break
    return [x for seg in pre + post for x in seg["losses"]]


def _check_elastic_records(rep, what: str, tier: str, steps: int,
                           shrink_tier="same") -> None:
    """Phases, the shrink at step 2 onto data 1 and batch 2, the regrow at
    4, both from anchor 2 in `tier` (the shrink from `shrink_tier` where it
    differs: a dark rank restores nothing there), `steps` steps, not
    stopped."""
    recs = rep["remeshes"]
    got = [(r["phase"], r["trigger_step"], r["restore_step"],
            r["restore_tier"], r["hosts"], r["old_data"], r["new_data"],
            r["old_batch"], r["new_batch"]) for r in recs]
    first = tier if shrink_tier == "same" else shrink_tier
    want = [("shrink", 2, 2, first, [1], 2, 1, BATCH, BATCH // 2),
            ("regrow", 4, 2, tier, [1], 1, 2, BATCH, BATCH)]
    check(got == want, f"{what}: remesh records {got}, not {want}")
    check(rep["decisions"] == ["fail_in_place"],
          f"{what}: decisions {rep['decisions']}")
    check(rep["steps"] == steps and not rep["stopped"]
          and not rep["completed_degraded"], f"{what}: {rep['summary']}")


def _remesh_line(r) -> str:
    return (f"remesh[{r['phase']}]: trigger step {r['trigger_step']}, "
            f"restored step {r['restore_step']} from tier "
            f"{r['restore_tier']}, hosts {r['hosts']}, data "
            f"{r['old_data']}->{r['new_data']}, batch "
            f"{r['old_batch']}->{r['new_batch']}, downtime "
            f"{r['downtime_s']:.3f} s")


def phase_elastic_train(kfp, seq_losses, seq_final, cfg=None,
                        dev=None) -> int:
    """Slice 12, elastic fail-in-place training in one process: qwen2-0.5b
    at full width and depth, the training cell (batch 4 x 256, adamw, 6
    steps) under L3 sequential (FSC and validated checkpoint every 2 on
    the flat disk) with a data axis of 2 hosts (`MeshConfig((2, 1))`), an
    `ElasticTrainer` scanning every 2 steps under a simulated cluster whose
    clock moves 100 s a scan and where host 1 is dark over [150, 250): a
    shrink at step 2 (anchor 2 from the disk, data 2 -> 1, batch 4 -> 2),
    2 degraded steps, a regrow at 4 that replays 2 -> 6. The full-width
    losses and the final per-leaf fingerprint must equal phase train's
    clean L3 run (`seq_losses`, `seq_final`) bit for bit. Prints the remesh
    records with their downtime, ms per executed step, the seconds of each
    checkpoint save and restore, peak memory and K1's launches (returned).
    """
    import shutil
    import tempfile

    from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                     TrainConfig, get_config)
    from repro_torch.launch.train import SimCluster
    from repro_torch.runtime.elastic import ElasticTrainer

    t_phase = time.time()
    _free()
    dev = dev or torch.device("cuda")
    cuda = dev.type == "cuda"
    cfg = cfg or pinned(get_config("qwen2-0.5b"))
    rc = RunConfig(
        model=cfg,
        train=TrainConfig(global_batch=BATCH, seq_len=TRAIN_SEQ,
                          steps=TRAIN_STEPS, warmup_steps=2),
        sedar=SedarConfig(level=3, replication="sequential",
                          validate_interval=1, param_validate_interval=2,
                          checkpoint_interval=2),
        mesh=MeshConfig(shape=(2, 1), axis_names=("data", "model")))
    root = tempfile.mkdtemp(prefix="sedar_elastic_")
    try:
        sim = SimCluster(os.path.join(root, "heartbeats"),
                         **ELASTIC_SCHEDULE)
        et = ElasticTrainer(rc, root, n_hosts=sim.n_hosts,
                            scan_interval=ELASTIC_SCAN, clock=sim.clock,
                            tick=sim.tick, device=dev,
                            notify=lambda e: None)
        saves: list = []
        restores: list = []
        _timed(et.trainer.recovery.store, "save", saves)
        _timed(et.trainer.recovery.store, "restore", restores)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kfp.launch_count.reset()
        t0 = time.time()
        rep = et.run(TRAIN_STEPS)
        wall = time.time() - t0
        k1 = kfp.launch_count.n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        out = {"remeshes": [dataclasses.asdict(r) for r in rep.remeshes],
               "decisions": [d.mode for d in rep.decisions],
               "segments": [dict(steps=g.steps_completed,
                                 losses=list(g.losses))
                            for g in rep.segments],
               "steps": rep.steps_completed, "stopped": rep.stopped,
               "completed_degraded": rep.completed_degraded,
               "summary": rep.summary()}
        executed = sum(len(g["losses"]) for g in out["segments"])
        print(f"elastic train: {rep.summary()}; {executed} steps executed "
              f"in {len(rep.segments)} segments, {wall:.1f} s "
              f"({wall * 1e3 / executed:.2f} ms per executed step, "
              f"transitions and checkpoints included); disk saves (async "
              f"submit) {[round(x, 3) for x in saves]} s of the original "
              f"trainer, restores {[round(x, 3) for x in restores]} s; "
              f"peak {peak:.2f} GiB; K1 launches {k1}", flush=True)
        for r in out["remeshes"]:
            print(f"  {_remesh_line(r)}", flush=True)
        for d in rep.decisions:
            print(f"  decision: {d.mode} (fail_in_place "
                  f"{d.fail_in_place_hours:.3f} h vs restart "
                  f"{d.restart_hours:.3f} h)", flush=True)
        _check_elastic_records(out, "elastic train", "disk", TRAIN_STEPS)
        full = _full_width_losses(out)
        check(full == list(seq_losses),
              f"elastic train: full-width losses {full} differ from the "
              f"clean L3 run's {list(seq_losses)}")
        check(np.array_equal(np.asarray(rep.final_state_fp)[:, :2],
                             np.asarray(seq_final)[:, :2]),
              "elastic train: the final state differs from the clean L3 "
              "run's")
        check(k1 > 0, "elastic train: K1 never launched")
        print(f"elastic train: full-width losses and final per-leaf "
              f"fingerprints bitwise equal to phase train's clean L3 run; "
              f"degraded losses "
              f"{[g['losses'] for g in out['segments'][1:-2]]}; phase took "
              f"{time.time() - t_phase:.1f} s", flush=True)
        del et, rep
        return k1
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_pod_elastic(kfp, cfg=None, device: str = "cuda") -> int:
    """Slice 12, elastic fail-in-place training on the pod backend's process
    mesh: qwen2-0.5b at full width and 2 of its 24 layers
    (POD_ELASTIC_LAYERS), the training cell (batch 4 x 256,
    adamw, 6 steps), 4 ranks of `MeshConfig((2, 2))` (2 pods x 2 data
    shards, batch 2 per rank) on this card over gloo, each the launcher's
    `launch/train.py::elastic_mesh_rank`: an uninterrupted run (L1, lag 4:
    no checkpoint, which fixes no bit), then the
    elastic run on `ckpt_tiers="device,partner"`, 1 ring slot, lag 4, on
    phase elastic_train's schedule. As the reference's acceptance scenario:
    phases shrink and regrow, the shrink restored from `partner` onto data
    1 (ranks 0 and 2) and batch 2, 6 steps, not stopped, no
    `commit_compare` read, and every rank's final state bitwise equal to
    its uninterrupted run's. Prints the remesh records with downtime per
    rank, each run's ms/step, peak per rank, K1 launches; returns K1's
    launches over the ranks."""
    import shutil
    import tempfile

    from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                     TrainConfig, get_config)
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import elastic_mesh_rank

    t_phase = time.time()
    _free()
    if device == "cuda":
        # the ranks are other processes: this one's cached blocks must go
        # back to the card first
        torch.cuda.empty_cache()
        print(f"pod elastic: this process keeps "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved "
              f"while the ranks run", flush=True)
    cfg = cfg or dataclasses.replace(get_config("qwen2-0.5b"),
                                     num_layers=POD_ELASTIC_LAYERS,
                                     remat=PINNED_REMAT)
    mesh = MeshConfig(shape=(2, 2), axis_names=("pod", "data"))
    sedar = SedarConfig(level=3, replication="pod", validate_interval=1,
                        validate_lag=4, param_validate_interval=2,
                        checkpoint_interval=2, ckpt_tiers="device,partner",
                        device_ring_slots=1)
    train = TrainConfig(global_batch=BATCH, seq_len=TRAIN_SEQ,
                        steps=TRAIN_STEPS, warmup_steps=2)
    rc = RunConfig(model=cfg, train=train, sedar=sedar, mesh=mesh)
    # the uninterrupted run keeps no checkpoint (L1): none fixes a bit, and
    # a ring slot would hold 5.93 GB more on each rank
    ref_rc = dataclasses.replace(rc, sedar=dataclasses.replace(
        sedar, level=1))
    root = tempfile.mkdtemp(prefix="sedar_pod_elastic_")
    try:
        t0 = time.time()
        reps = spawn(elastic_mesh_rank, 4, rc, mesh, root, ELASTIC_SCHEDULE,
                     device, None, ref_rc, dict(scan_interval=ELASTIC_SCAN),
                     threads=1 if device == "cpu" else 0,
                     timeout_s=POD_ELASTIC_TIMEOUT_S)
        t_ranks = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"pod elastic: 4 ranks (2 pods x 2 data shards) on one card took "
          f"{t_ranks:.1f} s (spawn, init, both runs)", flush=True)
    def gib(x) -> str:
        return "n/a" if x is None else f"{x:.2f} GiB"

    for rep in reps:
        e, r = rep["elastic"], rep["ref"]
        print(f"  rank {rep['rank']} (pod {rep['pod']}, data {rep['data']}): "
              f"uninterrupted {r['summary']}, {r['ms_step']:.2f} ms/step, "
              f"peak {gib(r['peak_gib'])}, K1 {r['k1']}; elastic "
              f"{e['summary']}, {e['ms_step']:.2f} ms per run step, peak "
              f"{gib(e['peak_gib'])}, K1 {e['k1']}, host reads {e['reads']}, "
              f"collectives {e['collectives']}", flush=True)
        for m in e["remeshes"]:
            print(f"    {_remesh_line(m)}", flush=True)
    survivors = [rep for rep in reps
                 if rep["elastic"]["remeshes"][0]["restore_tier"]]
    check([rep["rank"] for rep in survivors] == [0, 2],
          f"pod elastic: survivors {[rep['rank'] for rep in survivors]}")
    for rep in reps:
        e = rep["elastic"]
        _check_elastic_records(
            e, f"pod elastic rank {rep['rank']}", "partner", TRAIN_STEPS,
            shrink_tier="same" if rep in survivors else None)
        check("commit_compare" not in e["reads"],
              f"pod elastic rank {rep['rank']} read commit_compare: "
              f"{e['reads']}")
        check(not e["detections"] and not rep["ref"]["detections"],
              f"pod elastic rank {rep['rank']}: detections")
        check(np.array_equal(e["final_state_fp"],
                             rep["ref"]["final_state_fp"]),
              f"pod elastic rank {rep['rank']}: the elastic run does not end "
              f"bitwise on its uninterrupted run")
        check(np.array_equal(e["final_state_fp"],
                             reps[0]["elastic"]["final_state_fp"]),
              f"pod elastic rank {rep['rank']}: the ranks' states differ")
        full = _full_width_losses(e)
        check(full == rep["ref"]["losses"],
              f"pod elastic rank {rep['rank']}: full-width losses {full} "
              f"differ from the uninterrupted run's {rep['ref']['losses']}")
    k1 = sum(rep[k]["k1"] for rep in reps for k in ("ref", "elastic"))
    print(f"pod elastic: shrink from partner and regrow on every rank, every "
          f"rank bitwise equal to its uninterrupted run, no commit_compare "
          f"read; K1 launches {k1} over the ranks; phase took "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return k1


# F3 on the card, run AS's case: xlstm-125m at full depth (12 blocks), the
# families cell's prompt (B = 4 x 1,024), params and protocol.
F3_XLSTM = ("xlstm-125m", 4, 1024)
F3_STEPS = 8        # tokens per run: the fault's at the 7th


def phase_f3_xlstm(kfp, kfa) -> None:
    """F3's repair on the card: xlstm-125m's clean logit (1, 5) at position
    S + 5 lies in [1, 2) (1.25 in run AS), so the abft fault there (bit 30
    of checksum-block element (1, 5)) makes a NaN, which the reference's
    guard lets through (row 1 emitted token 5). The port's guard must flag
    it uncorrectable: one TDC, one retry, the clean run's tokens."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server

    t_phase = time.time()
    arch, B, S = F3_XLSTM
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
    rng = np.random.RandomState(7)
    prompt = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S))).to(dev)}
    none = make_server(RunConfig(model=cfg), backend="none", device=dev)
    params = none.model.init(seed=0)
    toks, rep, _, _ = _family_run(kfp, kfa, none, params, prompt,
                                  f"F3 {arch} {cfg.num_layers} blocks clean",
                                  steps=F3_STEPS)
    step = S + 5
    v5 = float(clean_logits(none, params, prompt, toks, S, step)[1][5])
    print(f"  F3: {arch}'s clean logit (1, 5) at position {step} is {v5!r}",
          flush=True)
    check(1.0 <= abs(v5) < 2.0, f"F3: {arch}'s clean logit (1, 5) {v5!r} "
          f"is not in [1, 2): bit 30 would make no NaN there")
    fsrv = make_server(RunConfig(model=cfg), backend="abft", device=dev,
                       inj_spec=InjectionSpec(
                           leaf_idx=0, flat_idx=cfg.vocab_size + 6, bit=30,
                           step=step, replica=0, target="kernel"))
    ftoks, frep, _, _ = _family_run(kfp, kfa, fsrv, params, prompt,
                                    "F3 abft fault at (1, 5)", steps=F3_STEPS)
    events = [(e.step, e.boundary, e.effect,
               bool(e.detail.get("abft_corrected"))) for e in frep.detections]
    print(f"  F3: events {events}, retries {frep.retries}, tokens equal the "
          f"clean run {np.array_equal(ftoks, toks)}", flush=True)
    check(events == [(step, "commit", "TDC", False)] and frep.retries == 1
          and not frep.stopped and np.array_equal(ftoks, toks),
          f"F3: {arch}'s NaN at (1, 5): events {events}, retries "
          f"{frep.retries}, or the tokens differ from the clean run")
    print(f"f3 phase took {time.time() - t_phase:.1f} s", flush=True)


# Slice 13, phase chunked: the reference's train_4k length (S = 4096) on
# qwen2-0.5b at full width and depth, one sequence on one card (the
# reference's train_4k has batch 256 over a pod: PERF.md section 4).
CHUNKED_SEQ = 4096
CHUNKED_TOL = 1e-2      # bf16 chunked vs plain attention: of max |x|


def _peak_gib(base: int) -> float:
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def chunked_attention_check() -> dict:
    """One qwen2-0.5b layer's attention at B = 1, S = 4096 (H 14, KV 2, hd
    64, bf16 from seeded normals), forward + backward: the plain (S, S)
    scores (`layers.causal_attention`) against the chunked causal form, ms
    and the peak above the inputs for each; outputs and grads within
    CHUNKED_TOL of the largest |value|."""
    from repro_torch.models import layers as nn
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, KV, hd = 1, CHUNKED_SEQ, 14, 2, 64
    q, k, v, ct = (torch.randn((B, S, n, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (H, KV, KV, H))
    out = {}
    for name, fn in (("plain", nn.causal_attention),
                     ("chunked", nn.chunked_causal_attention)):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def step():
            o = fn(*leaves)
            g = torch.autograd.grad((o.float() * ct.float()).sum(), leaves)
            return o, g
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o, g = step()
        torch.cuda.synchronize()
        peak = _peak_gib(base)
        ms = cuda_ms(step, 5, warmup=1)
        out[name] = (o.detach(), [x.detach() for x in g], ms, peak)
        print(f"chunked: one layer's attention fwd+bwd, {name}: {ms:.3f} ms, "
              f"peak {peak:.3f} GiB above the inputs", flush=True)
    errs = {}
    for i, what in enumerate(("out", "dq", "dk", "dv")):
        a = out["plain"][0] if i == 0 else out["plain"][1][i - 1]
        b = out["chunked"][0] if i == 0 else out["chunked"][1][i - 1]
        errs[what] = float((a.float() - b.float()).abs().max()
                           / a.float().abs().max())
    print(f"chunked: chunked vs plain, max abs err / max |plain|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    check(max(errs.values()) <= CHUNKED_TOL,
          f"chunked attention off the plain form beyond {CHUNKED_TOL}: {errs}")
    return {"plain_ms": out["plain"][2], "plain_gib": out["plain"][3],
            "chunked_ms": out["chunked"][2],
            "chunked_gib": out["chunked"][3], "errs": errs}


def policy_runs(kfp, what: str, batch: int, seq: int, steps: int,
                backends, policies, allow_oom: bool = False) -> dict:
    """Runs of qwen2-0.5b at full width and depth, attention_impl="xla",
    adamw, L1 (no checkpoint): one per (backend, remat policy) in turns,
    `steps` steps of TrainConfig(global_batch=batch, seq_len=seq) from the
    seed-0 state on SyntheticLM(151936, batch, seq, seed=0). Prints ms per
    step (the first step's warm-up included), the peak
    (`max_memory_allocated`), the losses and K1's launches; fails on a
    detection. Returns {(backend, policy): {"ms", "peak", "losses", "fp",
    "k1", "state_bytes"}}; a run that is out of memory is reported and
    left out under `allow_oom`."""
    from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                     get_config)
    from repro_torch.core.policy import make_trainer
    from repro_torch.data import SyntheticLM
    from repro_torch.tree import leaves
    import shutil
    import tempfile

    dev = torch.device("cuda")
    base = get_config("qwen2-0.5b")
    data = SyntheticLM(base.vocab_size, batch, seq, seed=0)
    root = tempfile.mkdtemp(prefix="sedar_remat_")
    out = {}
    try:
        for b in backends:
            for pol in policies:
                _free()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                rc = RunConfig(model=dataclasses.replace(base, remat=pol),
                               train=TrainConfig(global_batch=batch,
                                                 seq_len=seq, steps=steps,
                                                 warmup_steps=min(2, steps)),
                               sedar=SedarConfig(level=1, replication=b))
                tr = make_trainer(rc, os.path.join(root, f"{b}_{pol}"),
                                  data=data, notify=lambda e: None,
                                  device=dev)
                try:
                    state = tr.init_state(seed=0)
                    state_bytes = sum(t.numel() * t.element_size()
                                      for t in leaves(state))
                    held = [tr.engine.executor.init_dual(state)]
                    del state
                    torch.cuda.synchronize()
                    kfp.launch_count.reset()
                    t0 = time.time()
                    # the run holds the only reference to its first state,
                    # which it drops once a step has replaced it
                    dual, rep = tr.run(steps, dual=held.pop())
                    torch.cuda.synchronize()
                    ms = (time.time() - t0) * 1e3 / steps
                except torch.cuda.OutOfMemoryError as e:
                    if not allow_oom:
                        raise
                    msg = str(e).splitlines()[0][:200]
                    gib = torch.cuda.max_memory_allocated() / 2 ** 30
                    print(f"{what}: {b} remat={pol} at B = {batch}, S = "
                          f"{seq}: out of memory ({msg}); peak {gib:.2f} GiB",
                          flush=True)
                    del tr
                    continue
                n = kfp.launch_count.n
                peak = torch.cuda.max_memory_allocated()
                print(f"{what}: {b} remat={pol} at B = {batch}, S = {seq}: "
                      f"{ms:.1f} ms/step over {steps} step(s), peak "
                      f"{peak / 2 ** 30:.2f} GiB, losses {rep.losses}, K1 "
                      f"{n} launches, detections "
                      f"{[str(e) for e in rep.detections]}", flush=True)
                check(not rep.detections and rep.steps_completed == steps,
                      f"{what}: {b} remat={pol} detected {rep.detections} "
                      f"or did not complete")
                out[b, pol] = {"ms": ms, "peak": peak, "losses": rep.losses,
                               "fp": rep.final_state_fp, "k1": n,
                               "state_bytes": state_bytes}
                del tr, dual, rep
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free()
    return out


def check_policies_bitwise(runs: dict, what: str) -> None:
    """Every backend's runs under the remat policies: losses and final
    per-leaf fingerprints bitwise equal to its first policy's."""
    for b in {b for b, _ in runs}:
        pols = [p for bb, p in runs if bb == b]
        ref = runs[b, pols[0]]
        for p in pols[1:]:
            got = runs[b, p]
            same = (got["losses"] == ref["losses"]
                    and np.array_equal(got["fp"], ref["fp"]))
            print(f"{what}: {b} remat={p} losses and final per-leaf "
                  f"fingerprints bitwise equal to remat={pols[0]}: {same}",
                  flush=True)
            check(same, f"{what}: {b} under remat={p} differs from "
                  f"remat={pols[0]}")


def fwd_bwd_peaks(data, policies) -> dict:
    """One forward + backward of qwen2-0.5b's loss at B = 1, S = 4096
    (the trainer's `loss_and_grads`: autograd over its f32 params) under
    each remat policy: the peak, params and grads included, and ms (the
    first call's); fails unless the peaks fall in the policies' order of
    what they keep (full < minimal < none) and the losses and grads are
    bitwise equal. Returns {policy: peak bytes}."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, unflatten_like

    dev = torch.device("cuda")
    batch = {k: torch.from_numpy(np.asarray(v, np.int64)).to(dev)
             for k, v in data.batch(0).items()}
    peaks, ref = {}, None
    for pol in policies:
        _free()
        torch.cuda.empty_cache()
        model = build_model(dataclasses.replace(get_config("qwen2-0.5b"),
                                                remat=pol), dev)
        params = model.init(seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ps = [p.requires_grad_(True) for p in leaves(params)]
        loss = model.loss(unflatten_like(params, ps), batch)[0]
        grads = torch.autograd.grad(loss, ps)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        peaks[pol] = torch.cuda.max_memory_allocated()
        fp = [loss.detach().clone()] + [g.clone() for g in grads]
        print(f"chunked: forward + backward at B = 1, S = {CHUNKED_SEQ} "
              f"under remat={pol}: peak {peaks[pol] / 2 ** 30:.2f} GiB "
              f"(params and grads 2 x 1.84 GiB included), {ms:.1f} ms "
              f"(first call), loss {float(loss)!r}", flush=True)
        if ref is None:
            ref = fp
        else:
            check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(ref, fp)),
                  f"chunked: loss or grads under remat={pol} differ from "
                  f"remat={policies[0]}'s")
        del model, params, ps, loss, grads, fp
    order = sorted(peaks, key=peaks.get)
    print(f"chunked: forward + backward peaks in the order {order}",
          flush=True)
    check(order == ["full", "minimal", "none"],
          f"chunked: peaks {peaks} not in the order full < minimal < none")
    del ref
    _free()
    return peaks


def chunked_train_steps(kfp, backends=("none", "sequential"),
                        allow_oom: bool = False,
                        policies=(PINNED_REMAT,), peaks=()):
    """One training step of qwen2-0.5b at full width and depth at S = 4096
    per backend and remat policy (`policy_runs`: TrainConfig(global_batch
    =1, seq_len=4096), adamw, L1), the policies bitwise equal, one forward
    + backward under each of `peaks` (`fwd_bwd_peaks`), then one xla
    prefill at B = 1, S = 4096: peak, ms, K1's launches, detections (none
    allowed; sequential's replicas must agree bitwise). `allow_oom`, for a
    tree without the chunked forms: an out-of-memory step is reported and
    the next one runs. Returns (K1's launches in the sequential step of
    the first policy, the runs)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM

    cfg = get_config("qwen2-0.5b")
    dev = torch.device("cuda")
    runs = policy_runs(kfp, "chunked", 1, CHUNKED_SEQ, 1, backends, policies,
                       allow_oom)
    check_policies_bitwise(runs, "chunked")
    k1 = runs.get(("sequential", policies[0]), {}).get("k1", 0)
    if "sequential" in backends and ("sequential", policies[0]) in runs:
        check(k1 > 0, "chunked: K1 never launched on the grads")
    data = SyntheticLM(cfg.vocab_size, 1, CHUNKED_SEQ, seed=0)
    if peaks:
        fwd_bwd_peaks(data, peaks)
    from repro_torch.models import build_model
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    toks = torch.from_numpy(data.batch(0)["tokens"]).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        try:
            t0 = time.time()
            logits, cache = model.prefill(params, {"tokens": toks},
                                          CHUNKED_SEQ + 8)
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            print(f"chunked: xla prefill at B = 1, S = {CHUNKED_SEQ}: "
                  f"{ms:.1f} ms (first call), peak {_peak_gib(base):.2f} "
                  f"GiB above the params, logits finite "
                  f"{bool(torch.isfinite(logits).all())}", flush=True)
            check(bool(torch.isfinite(logits).all()),
                  "chunked: prefill logits not finite")
            del logits, cache
        except torch.cuda.OutOfMemoryError:
            if not allow_oom:
                raise
            print("chunked: xla prefill out of memory", flush=True)
    del params, model
    _free()
    return k1, runs


def phase_chunked(kfp):
    """Slices 13 and 14: the chunked attentions at the reference's train_4k
    length. One layer's attention plain vs chunked (ms, peak, agreement),
    then one `none` and one `sequential` training step of qwen2-0.5b at B =
    1, S = 4096 under each remat policy, the policies bitwise equal, peak
    and ms of each (phase remat's cell (b)), and one xla prefill
    (`chunked_train_steps`). Returns (K1's launches in the sequential
    step without remat, the runs)."""
    t_phase = time.time()
    _free()
    torch.cuda.empty_cache()
    chunked_attention_check()
    k1, runs = chunked_train_steps(kfp, policies=("none", "full"),
                                   peaks=REMAT_POLICIES)
    print(f"chunked phase took {time.time() - t_phase:.1f} s", flush=True)
    return k1, runs


# Slice 14, phase remat: activation rematerialization (ModelConfig.remat)
# under the trainers: (a) the training cell at the three policies under
# none, sequential and fused; (b) is phase chunked's S = 4096 step; (c)
# sequential at S = 4096 and B = 8 under "full", the batch remat makes
# room for.
REMAT_POLICIES = ("none", "minimal", "full")
REMAT_BACKENDS = ("none", "sequential", "fused")
REMAT_BIG_BATCH = 8
PLAN_TIMEOUT_S = 900


def phase_remat(kfp) -> dict:
    """(a) TrainConfig(global_batch=4, seq_len=256, steps=6) of qwen2-0.5b
    at full width and depth under none, sequential and fused, each with
    remat none, minimal and full (`policy_runs`): losses and final per-leaf
    fingerprints bitwise equal across the policies, ms/step, peak and K1
    launches; (c) one sequential step at B = 8, S = 4096 under full.
    Returns the runs (for phase plan) and K1's launches."""
    t_phase = time.time()
    runs = policy_runs(kfp, "remat", BATCH, TRAIN_SEQ, TRAIN_STEPS,
                       REMAT_BACKENDS, REMAT_POLICIES)
    check_policies_bitwise(runs, "remat")
    big = policy_runs(kfp, "remat", REMAT_BIG_BATCH, CHUNKED_SEQ, 1,
                      ("sequential",), ("full",))
    for (b, p), r in big.items():
        runs[b, p, REMAT_BIG_BATCH, CHUNKED_SEQ] = r
    print(f"remat phase took {time.time() - t_phase:.1f} s", flush=True)
    return runs


# the dry-run cells of phase plan: (B, S, remat policy, flavors); the
# first is the reference's train_4k shape at the config's own policy
PLAN_CELLS = ((256, 4096, None, ("baseline", "sedar")),
              (BATCH, TRAIN_SEQ, "none", ("baseline", "sedar")),
              (BATCH, TRAIN_SEQ, "minimal", ("baseline", "sedar")),
              (BATCH, TRAIN_SEQ, "full", ("baseline", "sedar")),
              (1, CHUNKED_SEQ, "none", ("baseline", "sedar")),
              (1, CHUNKED_SEQ, "full", ("baseline", "sedar")),
              (REMAT_BIG_BATCH, CHUNKED_SEQ, "full", ("sedar",)))


def plan_cells(out_path: str) -> None:
    """Every PLAN_CELLS cell of `launch/dryrun.py::run_cell` for
    qwen2-0.5b, on `meta` tensors in this process (no card), one after
    another on one thread, written to `out_path` as JSON: the phases on the
    card run meanwhile (`start_plan`)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    cells = {}
    for B, S, pol, flavors in PLAN_CELLS:
        cfg = get_config("qwen2-0.5b")
        if pol:
            cfg = dataclasses.replace(cfg, remat=pol)
        shape = ("train_4k" if pol is None
                 else ShapeSpec(f"train_{B}x{S}", "train", S, B))
        for fl in flavors:
            cells[f"{B} {S} {pol} {fl}"] = dryrun.run_cell(
                "qwen2-0.5b", shape, fl, cfg=cfg)
    with open(out_path + ".tmp", "w") as f:
        json.dump(cells, f, default=str)
    os.replace(out_path + ".tmp", out_path)


def start_plan():
    """Start `plan_cells` in a child process (CPU only); returns (the
    process, the JSON's path)."""
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="sedar_plan_"), "cells.json")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--plan-cells", path],
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    import atexit
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def phase_plan(remat_runs: dict, chunked_runs: dict, plan) -> None:
    """`launch/dryrun.py::run_cell` on the card's host: qwen2-0.5b at
    train_4k (baseline and sedar), then the cells that phases remat and
    chunked ran (B = 4 x 256 under every policy, B = 1 x 4096 under none
    and full, B = 8 x 4096 under full): the predicted state bytes must
    equal the trainer's state exactly; the predicted peak (L1 runs hold no
    ring slot) is printed beside the measured one, and their gap."""
    t_phase = time.time()
    proc, path = plan
    try:
        rc = proc.wait(timeout=PLAN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"plan: the dry-run cells took more than {PLAN_TIMEOUT_S} s")
    check(rc == 0 and os.path.exists(path),
          f"plan: the dry-run cells' process ended with {rc}")
    with open(path) as f:
        cells = json.load(f)
    import shutil
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    gib = 2 ** 30
    for flavor in ("baseline", "sedar"):
        cell = cells[f"256 4096 None {flavor}"]
        m = cell["memory"]
        print(f"plan: qwen2-0.5b train_4k {flavor} (remat {m['remat']}): "
              f"state {m['state_bytes']} B, resident "
              f"{m['resident_bytes'] / gib:.2f} GiB, activations "
              f"{m['activation_bytes_fixed'] / gib:.3f} GiB a step + "
              f"{m['activation_bytes_per_seq'] / gib:.3f} GiB a sequence, "
              f"peak {m['peak_bytes'] / gib:.2f} GiB at batch {m['batch']} "
              f"(fits {m['fits_80GB']}), largest batch {m['max_batch']}; "
              f"{cell['flops']['total']:.4e} FLOPs a step, "
              f"{cell['roofline']['dominant']} bound "
              f"{cell['roofline']['bound_s']:.3f} s (took "
              f"{cell['elapsed_s']} s)", flush=True)
    for B, S, pol, flavors in PLAN_CELLS[1:]:
        for fl in flavors:
            b = "none" if fl == "baseline" else "sequential"
            run = (remat_runs.get((b, pol)) if S == TRAIN_SEQ
                   else remat_runs.get((b, pol, B, S)) if B > 1
                   else chunked_runs.get((b, pol)))
            m = cells[f"{B} {S} {pol} {fl}"]["memory"]
            peak = m["peak_bytes"] - m["ring_slot_bytes"]    # L1: no ring
            print(f"plan: {b} remat={pol} B = {B}, S = {S}: state "
                  f"predicted {m['state_bytes']} B, the trainer's "
                  f"{run['state_bytes']} B; peak predicted "
                  f"{peak / gib:.2f} GiB, measured {run['peak'] / gib:.2f} "
                  f"GiB (gap {(run['peak'] - peak) / gib:+.2f} GiB; "
                  f"activations predicted {m['activation_bytes'] / gib:.3f}"
                  f" GiB)", flush=True)
            check(m["state_bytes"] == run["state_bytes"],
                  f"plan: predicted state {m['state_bytes']} B != the "
                  f"trainer's {run['state_bytes']} B")
    print(f"plan phase took {time.time() - t_phase:.1f} s", flush=True)


# Slice 13, phase ep: expert parallelism over a model axis of 2 ranks on
# this card, one phi3.5-moe layer at full width.
EP_SHAPE = (1, 2)           # (data, model)
EP_BATCH, EP_SEQ = 4, 256
EP_TIMING_ITERS = 3
EP_TOL = 1e-2               # bf16: of the oracle's max |value|
# the sharded pass at bf16: phase tp's bound for sharded bf16 grads
EP_SHARDED_BF16_GAP = FUSED_GRAD_GAP
EP_TIMEOUT_S = 300


def _ep_loss(model, params, batch, ctx=None, groups: int = 1):
    """(loss, metrics) of `model` with its MoE layers routing `groups`
    dispatch groups (the one-process oracle) or over `ctx`'s model group."""
    from repro_torch.models import moe
    if groups == 1:
        return model.loss(params, batch, ctx)
    real = moe.moe_mlp
    moe.moe_mlp = lambda cfg, p, x, g=1, ctx=None: real(cfg, p, x, groups)
    try:
        return model.loss(params, batch)
    finally:
        moe.moe_mlp = real


def _routed(fn, force=None):
    """(fn(), the router's top-k expert choices of each token, (T, k) in
    call order): `torch.topk` spied on, which only the MoE routing calls.
    `force` (T, k): those choices taken in the top-k's place, each with
    its own probability as its gate weight."""
    real, seen = torch.topk, []

    def spy(x, k, *args, **kwargs):
        vals, idx = real(x, k, *args, **kwargs)
        if force is not None:
            done = sum(t.shape[0] for t in seen)
            idx = force[done:done + idx.shape[0]].to(idx.device)
            vals = torch.gather(x, -1, idx)
        seen.append(idx.cpu())
        return vals, idx
    torch.topk = spy
    try:
        return fn(), torch.cat(seen)
    finally:
        torch.topk = real


def _ep_run(mesh, cfg, batch, sharded: bool) -> dict:
    """One pass of phase ep on this rank: the one-process oracle on the
    full params with the tokens in tp x D dispatch groups (its grads moved
    to the host), then `Model.loss` with a `ShardCtx` over the mesh: with
    `sharded`, every param cut to the rank's block (`bridge.shard_params`,
    the ctx holding their specs: the attention over its heads, the
    vocab-parallel embedding, head and CE, the experts over the model
    ranks); else every param whole but the rank's experts
    (`bridge.expert_shard`). Loss, aux, drop fraction and every grad
    against the oracle's, ms per forward + backward, the peak and the
    collectives by label, of a run with the oracle's routing forced
    (`_routed`); before it a run that routes freely gives `flips`, the
    tokens of the rank's slice whose top-k experts differ from the
    oracle's (a rounding that moves a router logit across its margin),
    and `free_worst`, its worst grads leaf against the oracle."""
    from repro_torch import bridge
    from repro_torch.core import hostsync
    from repro_torch.models import build_model
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.sharding import Resolver
    from repro_torch.tree import flatten_with_path, tree_map, unflatten_like

    dev = torch.device("cuda")
    D, tp = EP_SHAPE
    model = build_model(cfg, dev)
    full = model.init(seed=0)

    def grads_of(params, fn):
        names = [n for n, _ in flatten_with_path(params)]
        leaves = [t.detach().requires_grad_(True)
                  for _, t in flatten_with_path(params)]
        loss, metrics = fn(unflatten_like(params, leaves))
        gs = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, dict(zip(names, gs))

    # the oracle: one process, full params, tp x D dispatch groups
    (loss_o, met_o, g_o), route_o = _routed(lambda: grads_of(
        full, lambda p: _ep_loss(model, p, batch, groups=tp * D)))
    res = Resolver(mesh)
    if sharded:
        specs = bridge.partition(cfg, full, res)
        oracle = dict(flatten_with_path(bridge.shard_params(
            unflatten_like(full, list(g_o.values())), res, mesh, cfg,
            specs)))
        params = bridge.shard_params(full, res, mesh, cfg, specs)
        ctx = ShardCtx(mesh, res, specs=specs,
                       dtype=torch_dtype(cfg.dtype))
    else:
        n_exp = cfg.num_experts // tp
        sl = slice(mesh.model * n_exp, (mesh.model + 1) * n_exp)
        oracle = {k: (g[:, sl] if any(w in k for w in ("w_gate", "w_up",
                                                          "w_down"))
                      else g) for k, g in g_o.items()}
        params = bridge.expert_shard(full, tp, mesh.model)
        ctx = ShardCtx(mesh, res)
    oracle = {k: g.float().cpu() for k, g in oracle.items()}
    oracle_stats = tuple(float(t.detach()) for t in (
        loss_o, met_o["moe_aux"], met_o["moe_drop_frac"]))
    del g_o, loss_o, met_o
    params = tree_map(lambda t: t.clone(), params)
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    def run(force=None):
        return _routed(lambda: grads_of(
            params, lambda p: model.loss(p, batch, ctx)), force)

    def gaps(g):
        return {k: float((v.float() - oracle[k].to(dev)).abs().max())
                / max(float(oracle[k].abs().max()), 1e-30)
                for k, v in g.items()}
    # free routing: the tokens whose top-k differs from the oracle's, and
    # how far that moves the grads
    (_, _, g), route = run()
    n = route.shape[0]
    own_o = route_o[mesh.model * n:(mesh.model + 1) * n]
    flips = int((torch.sort(route, dim=-1).values
                 != torch.sort(own_o, dim=-1).values).any(dim=-1).sum())
    free_worst = max(gaps(g).values())
    del g
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the checked run, the oracle's routing forced; the backward runs on
    # autograd's device thread: count across threads
    with hostsync.count_transfers(cross_thread=True) as st:
        (loss, met, g), _ = run(own_o)
        torch.cuda.synchronize()
    peak_above = _peak_gib(base)
    held = base / 2 ** 30
    stats = tuple(float(t.detach()) for t in (
        loss, met["moe_aux"], met["moe_drop_frac"]))
    errs = gaps(g)
    bitwise = all(torch.equal(v.float().cpu(), oracle[k])
                  for k, v in g.items())
    del g
    times = []
    for _ in range(EP_TIMING_ITERS):
        torch.cuda.synchronize()
        t0 = time.time()
        grads_of(params, lambda p: model.loss(p, batch, ctx))
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    del params
    torch.cuda.empty_cache()
    return dict(stats=stats, oracle_stats=oracle_stats, errs=errs,
                bitwise=bitwise, held_gib=held, peak_gib=held + peak_above,
                collectives=dict(st.collectives), ms=times, flips=flips,
                free_worst=free_worst)


EP_SERVE_STEPS = 4
# one sharded prefill (SP) and one decode step of the ep layer on its 2
# model ranks, by label: the lookup's reduce-scatter (decode: its sum),
# the attention's SP gather and reduce-scatter (decode: its exit sum),
# MoE's SP gather, the last position's gather; EP's exchanges each way,
# the token gather and the two means
EP_SERVE_COLLECTIVES = (
    {"tp_gather": 3, "tp_scatter": 2, "ep_dispatch": 1, "ep_combine": 1,
     "ep_gather": 1, "ep_stats": 2},
    {"tp_reduce": 2, "ep_dispatch": 1, "ep_combine": 1, "ep_gather": 1,
     "ep_stats": 2})


def _ep_serve(mesh, cfg, batch) -> dict:
    """Slice 16 on phase ep's layer: `build_prefill_program` (SP on) and
    `build_decode_program` on the 2 model ranks, the bf16 serving params,
    the ep cell's tokens as prompts, EP_SERVE_STEPS decode steps fed the
    oracle's greedy tokens: EP at prefill (B x S tokens) and at decode (B
    rows, 2 per rank). The oracle, in this rank's process: `Model.prefill`
    and `Model.decode_step` on the whole params with the tokens in tp
    dispatch groups, as EP routes each rank's slice. The sharded run is
    held with the oracle's routing forced (`_routed`: a token routed
    otherwise moves its whole MLP output); a free run before it gives the
    tokens that route otherwise and its logits gap. Returns the worst
    logits row (of its max |logit|) and cache leaf (of its max) of the
    rank's blocks against the oracle's, the collectives per prefill and
    per step, and ms."""
    from repro_torch import bridge
    from repro_torch.configs import SHAPES
    from repro_torch.core import hostsync
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.sharding import Resolver, ShardingRules
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    tp, m = EP_SHAPE[1], mesh.model
    B, S = batch["tokens"].shape
    T = S + EP_SERVE_STEPS
    model = build_model(cfg, dev)
    full = model.init(seed=0)
    half = dryrun._half_params(full)
    prompt = {"tokens": batch["tokens"]}

    def oracle():
        from repro_torch.models import moe
        real = moe.moe_mlp
        moe.moe_mlp = lambda cfg, p, x, g=1, ctx=None: real(cfg, p, x, tp)
        try:
            with torch.no_grad():
                lg, cache = model.prefill(half, prompt, T)
                outs, toks = [lg.float()], []
                pre = {k: v.clone() for k, v in cache.items()}
                for i in range(EP_SERVE_STEPS):
                    toks.append(lg.argmax(-1))
                    lg, cache = model.decode_step(half, cache, toks[-1],
                                                  S + i)
                    outs.append(lg.float())
            return outs, toks, pre, cache
        finally:
            moe.moe_mlp = real
    (o_logits, toks, o_pre, o_end), route_o = _routed(oracle)
    del half
    shape_p = dataclasses.replace(SHAPES[0], kind="prefill", seq_len=S,
                                  global_batch=B)
    shape_d = dataclasses.replace(SHAPES[0], kind="decode", seq_len=T,
                                  global_batch=B)
    pre, _ = dryrun.build_prefill_program(
        cfg, shape_p, mesh, Resolver(mesh, ShardingRules(
            sequence_parallel=True)), max_len=T)
    dec, _ = dryrun.build_decode_program(cfg, shape_d, mesh, Resolver(mesh))
    params = tree_map(lambda t: t.clone(), pre.shard_params(full))
    del full
    torch.cuda.empty_cache()
    V = o_logits[0].shape[-1] // tp
    own = [lg[:, m * V:(m + 1) * V] for lg in o_logits]
    sizes, c = bridge.mesh_sizes(dec.resolver), bridge.mesh_coords(mesh)

    def run(force=None):
        def go():
            colls, ms = [], []
            with hostsync.count_transfers() as st:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = pre(params, prompt)
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            colls.append(dict(st.collectives))
            outs = [lg.float()]
            pre_c = {k: v.clone() for k, v in cache.items()}
            for i in range(EP_SERVE_STEPS):
                with hostsync.count_transfers() as st:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, cache = dec(params, cache, toks[i], S + i)
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                colls.append(dict(st.collectives))
                outs.append(lg.float())
            return outs, pre_c, cache, colls, ms
        return _routed(go, force)

    def gaps(outs, pre_c, end):
        lg = max(float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
                 for a, b in zip(outs, own))
        cache = max(float((got[k].float() - bridge.shard_leaf(
            want[k], dec.cache_specs[k], c, sizes).float()).abs().max()
            / want[k].float().abs().max()) for got, want in
            ((pre_c, o_pre), (end, o_end)) for k in got)
        return lg, cache
    # the oracle routes the prefill's B x S tokens, then each step's B, in
    # one call each; EP routes each call's m-th slice of them on rank m
    calls = route_o.split([B * S] + [B] * EP_SERVE_STEPS)
    force = torch.cat([t[m * (t.shape[0] // tp):(m + 1) * (t.shape[0] // tp)]
                       for t in calls])
    (outs, pre_c, end, _, _), route = run()
    flips = int((torch.sort(route, dim=-1).values
                 != torch.sort(force, dim=-1).values).any(dim=-1).sum())
    free = gaps(outs, pre_c, end)
    (outs, pre_c, end, colls, ms), _ = run(force)
    logit_gap, cache_gap = gaps(outs, pre_c, end)
    del params, outs, pre_c, end
    torch.cuda.empty_cache()
    return dict(logit_gap=logit_gap, cache_gap=cache_gap, flips=flips,
                free=free, collectives=colls, ms=ms)


def ep_rank(rank: int, root: str) -> dict:
    """One rank of phase ep (spawned by `launch/mesh.py::spawn`): a
    1-layer phi3.5-moe at full width (seeded f32 params), B = 4 x 256
    tokens of SyntheticLM(seed 0), over MeshConfig((1, 2), ("data",
    "model")): `_ep_run` with every param whole but the experts (slice
    13, the config's bf16 compute), then with every layer sharded (slice
    15) at f32 compute and at bf16. The seeded router's top-2 of 16
    margins are thin, and a product that rounds one element otherwise
    than the oracle's can route a token to another expert, which moves the
    grads of every leaf it reaches; so each pass is held with the oracle's
    routing forced, and the free run's re-routed tokens and grads gap are
    printed beside it. Slice 16 then serves the layer through the sharded
    serving programs (`_ep_serve`)."""
    from repro_torch.configs import MeshConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_deterministic
    from repro_torch.launch.mesh import make_process_mesh

    dev = torch.device("cuda")
    make_deterministic(dev)
    mesh = make_process_mesh(MeshConfig(shape=EP_SHAPE,
                                        axis_names=("data", "model")))
    cfg = pinned(cut_depth(get_config("phi3.5-moe-42b-a6.6b"), 1))
    batch = {k: torch.from_numpy(np.asarray(v, np.int64)).to(dev)
             for k, v in SyntheticLM(cfg.vocab_size, EP_BATCH, EP_SEQ,
                                     seed=0).batch(0).items()}
    out, secs = dict(rank=rank, model=mesh.model), {}
    for name, fn in (
            ("ep", lambda: _ep_run(mesh, cfg, batch, sharded=False)),
            ("tp32", lambda: _ep_run(mesh, dataclasses.replace(
                cfg, dtype="float32"), batch, sharded=True)),
            ("tp", lambda: _ep_run(mesh, cfg, batch, sharded=True)),
            ("serve", lambda: _ep_serve(mesh, cfg, batch))):
        t0 = time.time()
        out[name] = fn()
        secs[name] = time.time() - t0
    return dict(out, seconds=secs)


# phase ep's sharded pass, a forward and backward by label: the experts'
# (as the experts-only pass), and on the model axis (SP off) attention's
# entry (its grad sum) and exit (the sum), the embedding's exit and the
# head's entry; 2 vocab_stats for the one CE chunk
EP_TP_COLLECTIVES = {"ep_dispatch": 2, "ep_combine": 2, "ep_gather": 3,
                     "ep_stats": 2, "tp_reduce": 4, "vocab_stats": 2}


def phase_ep() -> dict:
    """Slice 13: expert parallelism (`models/moe.py::moe_mlp_ep`) over a
    model axis of 2 ranks, each a process on this one card over gloo: one
    phi3.5-moe layer at full width (d 4096, 16 experts top-2, d_ff 6400, 8
    experts per rank), B = 4 x 256 tokens, a forward and a loss backward
    through `Model.loss(ctx=)` against the one-process oracle with the
    tokens in the same 2 dispatch groups: loss and aux within EP_TOL
    relative, the drop fraction equal, every grad within EP_TOL of the
    oracle's largest |value| (bitwise printed); ms per forward + backward,
    peak per rank and the collectives by label. Slice 15 runs the layer
    again with every param sharded over the 2 model ranks (the attention
    over its heads, the vocab-parallel embedding, head and CE beside the
    experts), held the same way at f32 compute, and at the config's bf16
    with grads within EP_SHARDED_BF16_GAP (phase tp's bound: the ranks'
    bf16 products and the oracle's round differently, an ulp or two of the
    largest grads), its collectives as EP_TP_COLLECTIVES states them. Each
    pass is held with the oracle's routing forced, and prints the tokens
    that route otherwise, and the grads gap, when it routes freely
    (`_ep_run`)."""
    import tempfile
    from repro_torch.launch.mesh import spawn

    t_phase = time.time()
    _free()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="sedar_ep_")
    reps = spawn(ep_rank, EP_SHAPE[0] * EP_SHAPE[1], root,
                 timeout_s=EP_TIMEOUT_S)
    # the experts: forward one exchange each way, the output's all_gather,
    # the two means; backward the exchanges again, the token slice's
    # all_gather and the router's sum (both ep_gather); with every layer
    # sharded also the model axis' (EP_TP_COLLECTIVES)
    want = {"ep": {"ep_dispatch": 2, "ep_combine": 2, "ep_gather": 3,
                   "ep_stats": 2}, "tp32": EP_TP_COLLECTIVES,
            "tp": EP_TP_COLLECTIVES}
    for rep in reps:
        for run, tol in (("ep", EP_TOL), ("tp32", EP_TOL),
                         ("tp", EP_SHARDED_BF16_GAP)):
            r = rep[run]
            (loss, aux, drop), (lo, ao, do) = r["stats"], r["oracle_stats"]
            worst = max(r["errs"], key=r["errs"].get)
            print(f"ep[{run}]: rank {rep['rank']} (model {rep['model']}): "
                  f"loss {loss!r} (oracle {lo!r}), aux {aux!r} ({ao!r}), "
                  f"drop fraction {drop!r} ({do!r}); grads bitwise equal to "
                  f"the oracle {r['bitwise']}, worst {worst} "
                  f"{r['errs'][worst]:.3e} of max |g| with the oracle's "
                  f"routing (routing freely: {r['flips']} tokens routed "
                  f"otherwise, worst {r['free_worst']:.3e}); fwd+bwd "
                  f"{', '.join(f'{t:.1f}' for t in r['ms'])} ms; params "
                  f"{r['held_gib']:.2f} GiB, peak {r['peak_gib']:.2f} GiB; "
                  f"collectives {r['collectives']}", flush=True)
            check(drop == do and abs(loss - lo) <= EP_TOL * abs(lo)
                  and abs(aux - ao) <= EP_TOL * abs(ao)
                  and r["errs"][worst] <= tol,
                  f"ep[{run}]: rank {rep['rank']} off the one-process "
                  f"oracle: loss {loss} vs {lo}, aux {aux} vs {ao}, drop "
                  f"{drop} vs {do}, {worst} {r['errs'][worst]} (the "
                  "oracle's routing forced)")
            check(r["collectives"] == want[run],
                  f"ep[{run}]: collectives {r['collectives']}, the code "
                  f"implies {want[run]}")
    for rep in reps:
        r = rep["serve"]
        print(f"ep[serve]: rank {rep['rank']} (model {rep['model']}): "
              f"logits {r['logit_gap']:.3e} of a row's max, cache "
              f"{r['cache_gap']:.3e} of a leaf's max against the oracle's "
              f"blocks with its routing (routing freely: {r['flips']} "
              f"tokens routed otherwise, logits {r['free'][0]:.3e}, cache "
              f"{r['free'][1]:.3e}); prefill {r['ms'][0]:.1f} ms, decode "
              f"ms/step {', '.join(f'{t:.1f}' for t in r['ms'][1:])}; "
              f"collectives {r['collectives'][0]}, {r['collectives'][1]}; "
              f"seconds per pass {rep['seconds']}", flush=True)
        check(r["logit_gap"] <= TP_SERVE_TOL
              and r["cache_gap"] <= TP_SERVE_TOL,
              f"ep[serve]: rank {rep['rank']} logits {r['logit_gap']}, "
              f"cache {r['cache_gap']} off the oracle (the oracle's "
              "routing forced)")
        pre_want, dec_want = EP_SERVE_COLLECTIVES
        check(r["collectives"][0] == pre_want
              and all(c == dec_want for c in r["collectives"][1:]),
              f"ep[serve]: collectives {r['collectives']}, the code implies "
              f"{EP_SERVE_COLLECTIVES}")
    print(f"ep phase took {time.time() - t_phase:.1f} s", flush=True)
    return {r["rank"]: r for r in reps}


TP_BATCH, TP_SEQ, TP_STEPS = 4, 256, 3
TP_LAYERS = 24              # qwen2-0.5b at full depth and width
TP_LOSS_RTOL = 5e-3         # each step's loss against the one-process oracle
TP_GRAD_GAP = FUSED_GRAD_GAP    # step 0's grads: of each leaf's max |g|
TP_FAULT = (0, 5, 20)       # grads leaf 0, element 5, bit 20
TP_FAULT_RANK = 3           # pod 1's rank (data 0, model 1) of (2, 1, 2)
TP_FAULT_STEP = 1
TP_TIMEOUT_S = 600
TP_THREADS = 2              # torch threads per rank: 4 ranks on 8 cores
# (name, mesh, flavor, microbatches): every run from the seed-0 state
TP_RUNS = (("baseline_m1", ((2, 2), ("data", "model")), "baseline", 1),
           ("baseline_m2", ((2, 2), ("data", "model")), "baseline", 2),
           ("sedar", ((2, 1, 2), ("pod", "data", "model")), "sedar", 1))


def tp_collectives(flavor: str, micro: int) -> dict:
    """One step's collectives by label on phase tp's meshes, as the code
    places them (qwen2-0.5b: tied, SP on, heads, kv heads, d_ff and vocab
    split over the 2 model ranks; L = TP_LAYERS): per layer and
    microbatch one FSDP bucket gathered and reduce-scattered and the
    biases' data sum, 4 model-axis gathers and 4 reduce-scatters (each
    block's entry and exit, forward and backward) and the two norms' grad
    sums; per microbatch the lookup's, the head's and the final norm's
    FSDP gathers and reduce-scatters, the embedding's exit and the head's
    entry, the final norm's grad sum and 2 vocab_stats (one CE chunk);
    per step the loss mean over the data ranks, one clip-norm sum per
    axis of more than one rank, and under sedar (data 1) the pod compare
    and the verdict."""
    L, M = TP_LAYERS, micro
    want = {"tp_gather": (4 * L + 2) * M, "tp_scatter": (4 * L + 2) * M,
            "tp_reduce": (2 * L + 1) * M, "vocab_stats": 2 * M}
    if flavor == "sedar":
        return dict(want, grad_norm=1, fp_gather=1, verdict=1)
    return dict(want, fsdp_gather=(L + 3) * M, fsdp_scatter=(L + 3) * M,
                fsdp_reduce=L * M, loss_mean=1, grad_norm=2)


def tp_setup(device: str = "cuda"):
    """phase tp's model, optimizer config, shape and data: qwen2-0.5b at
    full width, TP_LAYERS deep (xla attention, adamw, remat as pinned), B
    = 4 x 256 tokens of SyntheticLM(151936, 4, 256, seed=0), one batch
    per step."""
    from repro_torch.configs import SHAPES, TrainConfig, get_config
    from repro_torch.data import SyntheticLM
    cfg = dataclasses.replace(pinned(cut_depth(get_config("qwen2-0.5b"),
                                               TP_LAYERS)),
                              attention_impl="xla")
    tc = TrainConfig(global_batch=TP_BATCH, seq_len=TP_SEQ, warmup_steps=2)
    shape = dataclasses.replace(SHAPES[0], kind="train", seq_len=TP_SEQ,
                                global_batch=TP_BATCH)
    data = SyntheticLM(cfg.vocab_size, TP_BATCH, TP_SEQ, seed=0)
    batches = [{k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
                for k, v in data.batch(i).items()} for i in range(TP_STEPS)]
    return cfg, tc, shape, batches


def tp_rules():
    from repro_torch.sharding import ShardingRules
    return ShardingRules(data_axes=("data",), sequence_parallel=True)


def tp_oracle(root: str) -> dict:
    """The program on a mesh of one rank in this process (the unsharded
    code): TP_STEPS baseline steps from the seed-0 state, each step's loss
    and ms, step 0's f32 grads saved under `root` for the ranks; and the
    f32 truth of step 0's grads (the same bf16 half params at f32
    compute), saved too, with the oracle's distance to it per leaf: the
    bf16 noise that the ranks' distance to the oracle is read against."""
    from repro_torch.configs import MeshConfig
    from repro_torch.core import hostsync
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding import Resolver
    from repro_torch.tree import flatten_with_path, leaves, unflatten_like

    cfg, tc, shape, batches = tp_setup()
    mesh = local_mesh(MeshConfig(shape=(1, 1), axis_names=("data", "model")))
    prog, _ = dryrun.build_train_program(cfg, shape, mesh,
                                         Resolver(mesh, tp_rules()),
                                         "baseline", tc, 1, device="cuda")
    params = build_model(cfg, "cuda").init(seed=0)
    state = {"params": params, "opt": make_optimizer(tc).init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    losses, ms = [], []
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        grads = [] if i == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = prog(state, batch, grads_out=grads)
        losses.append(float(hostsync.read_scalar(loss, "loss")))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            g = dict(flatten_with_path(unflatten_like(
                state["params"], [t.cpu() for t in grads])))
            torch.save(g, os.path.join(root, "oracle_grads.pt"))
            del grads, g
    peak = _peak_gib(base) + base / 2 ** 30
    del state, prog
    _free()
    torch.cuda.empty_cache()
    # the f32 truth of step 0's grads: the same half params, f32 compute
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32, "cuda")
    half = [p.to(torch.bfloat16).float().requires_grad_(True)
            for p in leaves(model32.init(seed=0))]
    g32 = torch.autograd.grad(model32.loss(unflatten_like(params, half),
                                           batches[0])[0], half)
    g32 = dict(zip([p for p, _ in flatten_with_path(params)],
                   [t.cpu() for t in g32]))
    torch.save(g32, os.path.join(root, "oracle_grads_f32.pt"))
    bf16 = torch.load(os.path.join(root, "oracle_grads.pt"))
    to_f32 = {p: float((bf16[p].float() - t).abs().max())
              / max(float(t.abs().max()), 1e-30) for p, t in g32.items()}
    del half, g32, bf16, model32, params
    _free()
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "peak_gib": peak, "to_f32": to_f32}


def tp_rank(rank: int, root: str) -> dict:
    """One rank of phase tp (spawned by `launch/mesh.py::spawn`): each run
    of TP_RUNS through `launch/dryrun.py::build_train_program` on this
    rank's block of the seed-0 state (`TrainProgram.shard_state`) and its
    rows of each batch: per step the loss, eq (sedar), ms, the collectives
    and bytes received by label (across threads: the backward runs on
    autograd's device thread), K1 launches; the peak; step 0's f32 grads
    block against the oracle's block (max |diff| and max |g| per leaf)
    and against the first run's (microbatches 2 vs 1); the state bytes
    held. sedar also runs the fault: TP_FAULT on rank TP_FAULT_RANK at
    step TP_FAULT_STEP, each rank committing only on eq."""
    import gc

    from repro_torch import bridge
    from repro_torch.configs import MeshConfig
    from repro_torch.core import hostsync
    from repro_torch.device import make_deterministic
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import Resolver
    from repro_torch.tree import (flatten_with_path, leaves, tree_map,
                                  unflatten_like)

    dev = torch.device("cuda")
    make_deterministic(dev)
    cfg, tc, shape, batches = tp_setup()
    oracle = torch.load(os.path.join(root, "oracle_grads.pt"), mmap=True)
    truth = torch.load(os.path.join(root, "oracle_grads_f32.pt"), mmap=True)
    out, first = {}, None      # baseline_m1's grads, for baseline_m2
    for name, (mshape, names), flavor, micro in TP_RUNS:
        mesh = make_process_mesh(MeshConfig(shape=mshape, axis_names=names))
        res = Resolver(mesh, tp_rules())
        prog, _ = dryrun.build_train_program(cfg, shape, mesh, res, flavor,
                                             tc, micro, device="cuda")
        full = build_model(cfg, dev).init(seed=0)
        params = tree_map(lambda t: t.clone(), bridge.shard_params(
            full, res, mesh, cfg, prog.specs["params"]))
        del full
        torch.cuda.empty_cache()
        start = {"params": params,
                 "opt": {k: tree_map(torch.zeros_like, params)
                         for k in ("m", "v")},
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        held = sum(t.numel() * t.element_size() for t in leaves(start))
        rows = [prog.shard_batch(b) for b in batches]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec = {"losses": [], "eq": [], "ms": [], "collectives": [],
               "bytes": [], "k1": [], "held_bytes": held,
               "coords": bridge.mesh_coords(mesh)}
        state = start
        for i, b in enumerate(rows):
            grads = [] if i == 0 else None
            kfp.launch_count.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hostsync.count_transfers(cross_thread=True) as st:
                state, aux = prog(state, b, grads_out=grads)
                if flavor == "sedar":
                    loss, eq, _ = aux
                    rec["eq"].append(bool(hostsync.read_bool(eq, "eq")))
                else:
                    loss = aux
                rec["losses"].append(float(hostsync.read_scalar(loss,
                                                                "loss")))
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["collectives"].append(dict(st.collectives))
            rec["bytes"].append(dict(st.collective_bytes))
            rec.setdefault("seconds", []).append(dict(st.collective_seconds))
            rec["k1"].append(kfp.launch_count.n)
            if i == 0:
                g = dict(flatten_with_path(unflatten_like(state["params"],
                                                          grads)))
                blocks = dict(zip(g, bridge.spec_leaves(
                    state["params"], prog.specs["params"])))
                sizes, c = bridge.mesh_sizes(res), bridge.mesh_coords(mesh)
                rec["grad_err"], rec["to_f32"] = {}, {}
                for p, t in g.items():
                    want = bridge.shard_leaf(oracle[p], blocks[p], c, sizes)
                    rec["grad_err"][p] = (
                        float((t.float().cpu() - want).abs().max()),
                        float(want.abs().max()))
                    want = bridge.shard_leaf(truth[p], blocks[p], c, sizes)
                    rec["to_f32"][p] = (
                        float((t.float().cpu() - want).abs().max()),
                        float(want.abs().max()))
                if name == "baseline_m1":
                    first = {p: t.float().cpu() for p, t in g.items()}
                elif name == "baseline_m2":
                    rec["vs_first"] = {p: (float((g[p].float().cpu()
                                                  - first[p]).abs().max()),
                                           float(first[p].abs().max()))
                                       for p in g}
                    first = None
                del g, grads
        rec["peak_gib"] = _peak_gib(base) + base / 2 ** 30
        if flavor == "sedar":
            state, eqs, committed, losses, done = start, [], [], [], 0
            kfp.launch_count.reset()
            for i in range(TP_STEPS):
                fault = (TP_FAULT if i == TP_FAULT_STEP
                         and rank == TP_FAULT_RANK else None)
                cand, (loss, eq, _) = prog(state, rows[done], fault=fault)
                ok = bool(hostsync.read_bool(eq, "eq"))
                eqs.append(ok)
                losses.append(float(hostsync.read_scalar(loss, "loss")))
                if ok:                  # the runtime's gate
                    state, done = cand, done + 1
                committed.append(done)
                del cand
            rec["fault"] = {"eq": eqs, "committed": committed,
                            "losses": losses, "k1": kfp.launch_count.n}
        out[name] = rec
        del state, start, params, prog
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_tp() -> int:
    """Slice 15: the sharded training program (`launch/dryrun.py::
    build_train_program`) of qwen2-0.5b at full width (TP_LAYERS deep) on
    4 ranks of this one card over gloo: baseline on (data, model) = (2, 2)
    with sequence parallelism at microbatches 1 and 2, and sedar on (pod,
    data, model) = (2, 1, 2): a clean run and a grads fault. Each from the
    seed-0 state, TP_STEPS steps of TP_BATCH x TP_SEQ tokens, against the
    program on a mesh of one rank in this process (the oracle, freed
    before the ranks start): every step's loss within TP_LOSS_RTOL, step
    0's gathered grads within TP_GRAD_GAP of each leaf's max |g|,
    microbatches 2 within those bounds of 1; sedar eq on every rank at
    every step, the fault flagged on all 4 ranks at its step and not
    committed (the retry clean); the collectives per step by label as
    `tp_collectives` states them; each rank's state bytes as
    `dryrun.plan_ranks` plans them. Prints ms/step, the peak per rank and
    the bytes through gloo per step. Returns the K1 launches (sedar's
    per-rank grads fingerprint)."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import spawn

    t_phase = time.time()
    _free()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="sedar_tp_")
    orc = tp_oracle(root)
    print(f"tp: oracle (one process, the unsharded code): losses "
          f"{orc['losses']}, ms/step {', '.join(f'{t:.1f}' for t in orc['ms'])}"
          f", peak {orc['peak_gib']:.2f} GiB", flush=True)
    t_spawn = time.time()
    reps = spawn(tp_rank, 4, root, threads=TP_THREADS,
                 timeout_s=TP_TIMEOUT_S)
    print(f"tp: 4 ranks took {time.time() - t_spawn:.1f} s, spawn included",
          flush=True)
    cfg, tc, shape, _ = tp_setup("cpu")
    k1, bad = 0, []

    def expect(cond: bool, msg: str) -> None:
        """A check of this phase, read at its end (every run printed)."""
        if not cond:
            print(f"tp: FAILED {msg}", flush=True)
            bad.append(msg)
    for name, (mshape, names), flavor, micro in TP_RUNS:
        sizes = dict(zip(names, mshape))
        want = tp_collectives(flavor, micro)
        plan = dryrun.plan_ranks(cfg, sizes, tp_rules(), flavor)
        worst, worst32 = {}, {}
        for r, rep in enumerate(reps):
            rec = rep[name]
            for w, key in ((worst, "grad_err"), (worst32, "to_f32")):
                for p, (d, m) in rec[key].items():
                    a, b = w.get(p, (0.0, 0.0))
                    w[p] = (max(a, d), max(b, m))
            secs = rec["seconds"][-1]
            print(f"tp {name}: rank {r} host s in collectives (last step) "
                  f"{sum(secs.values()):.3f}: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(
                          secs.items(), key=lambda kv: -kv[1])), flush=True)
            gib = [sum(b.values()) / 2 ** 30 for b in rec["bytes"]]
            print(f"tp {name}: rank {r} {rec['coords']}: losses "
                  f"{rec['losses']} eq {rec['eq']}; ms/step "
                  f"{', '.join(f'{t:.1f}' for t in rec['ms'])}; peak "
                  f"{rec['peak_gib']:.2f} GiB; state held "
                  f"{rec['held_bytes']} B; gloo GiB received per step "
                  f"{', '.join(f'{x:.4f}' for x in gib)} "
                  f"({rec['bytes'][-1]}); K1 {rec['k1']}", flush=True)
            for i, (lo, lw) in enumerate(zip(rec["losses"], orc["losses"])):
                expect(abs(lo - lw) <= TP_LOSS_RTOL * abs(lw),
                      f"tp {name}: rank {r} step {i} loss {lo} vs the "
                      f"oracle's {lw}")
            for i, c in enumerate(rec["collectives"]):
                expect(c == want, f"tp {name}: rank {r} step {i} "
                      f"collectives {c}, the code implies {want}")
            expect(rec["held_bytes"] == plan["ranks"][r]["state_bytes"],
                  f"tp {name}: rank {r} holds {rec['held_bytes']} B of "
                  f"state, run_cell plans {plan['ranks'][r]['state_bytes']}")
            if flavor == "sedar":
                expect(rec["eq"] == [True] * TP_STEPS,
                      f"tp sedar: rank {r} clean eq {rec['eq']}")
                f = rec["fault"]
                expect(f["eq"] == [True, False, True]
                      and f["committed"] == [1, 1, 2]
                      and f["losses"][2] == rec["losses"][1],
                      f"tp sedar: rank {r} fault run {f} (clean losses "
                      f"{rec['losses']})")
                expect(rec["k1"] == [1] * TP_STEPS and f["k1"] == TP_STEPS,
                      f"tp sedar: rank {r} K1 launches {rec['k1']}, "
                      f"{f['k1']} in the fault run (one per step)")
                k1 += sum(rec["k1"]) + f["k1"]
            if "vs_first" in rec:
                gap = max(d / max(m, 1e-30)
                          for d, m in rec["vs_first"].values())
                print(f"tp {name}: rank {r} step-0 grads vs baseline_m1 "
                      f"{gap:.3e} of max |g|", flush=True)
                expect(gap <= TP_GRAD_GAP, f"tp {name}: rank {r} grads "
                      f"{gap} of max |g| off microbatches 1")
        gaps = {p: d / max(m, 1e-30) for p, (d, m) in worst.items()}
        gaps32 = {p: d / max(m, 1e-30) for p, (d, m) in worst32.items()}
        top = sorted(gaps, key=gaps.get, reverse=True)[:4]
        print(f"tp {name}: step-0 grads vs the oracle, worst "
              + ", ".join(f"{p} {gaps[p]:.3e} (to the f32 grads: "
                          f"{gaps32[p]:.3e}, the oracle's "
                          f"{orc['to_f32'][p]:.3e})" for p in top)
              + f" of max |g|; collectives per step {want}", flush=True)
        for p in top:
            expect(gaps[p] <= TP_GRAD_GAP, f"tp {name}: grads {p} "
                   f"{gaps[p]} of max |g| off the oracle")
    print(f"tp phase took {time.time() - t_phase:.1f} s", flush=True)
    check(not bad, "; ".join(bad[:8]))
    return k1


TP_SERVE_BATCH, TP_SERVE_PROMPT = 4, 256
# teacher-forced decode steps and internvl2-2b's depth, cut for the
# script's time (PERF.md section 4): 16 and 8 steps at 2 layers in the
# first chip run (a step of 4 ranks on the one card took 1.4-2.2 s on
# (2, 2), 0.95-1.8 s on (1, 4), 1.7-2.3 s for internvl2-2b: the phase
# 178.3 s), then 4 and 2 (73.4-80.4 s; the whole script 1,292.1 s)
TP_SERVE_STEPS = 2           # qwen2-0.5b
TP_SERVE_VLM_LAYERS = 1      # internvl2-2b: 1 of 24 layers, full width
TP_SERVE_VLM_STEPS = 1
TP_SERVE_TOL = 3e-2          # bf16: of each row's max |logit| (cache: leaf)
TP_SERVE_TIMEOUT_S = 600
# (arch, run, (data, model)); every rank runs them in this order
TP_SERVE_RUNS = (("qwen2-0.5b", "a", (2, 2)), ("qwen2-0.5b", "b", (1, 4)),
                 ("internvl2-2b", "a", (2, 2)))


def tp_serve_setup(arch: str):
    """(cfg, the numpy batch, decode steps, frontend positions P) of phase
    tp_serve: qwen2-0.5b at full width and depth, or internvl2-2b at
    TP_SERVE_VLM_LAYERS layers and full width, `attention_impl="pallas"`
    (K2 on each rank's heads or rows); TP_SERVE_BATCH prompts of
    TP_SERVE_PROMPT tokens from numpy seed 0 at the vocab, internvl2's 256
    stub patch embeddings 0.1 N(0, 1) from numpy seed 1."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    steps = TP_SERVE_STEPS
    if cfg.family == "vlm":
        cfg, steps = cut_depth(cfg, TP_SERVE_VLM_LAYERS), TP_SERVE_VLM_STEPS
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    x = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TP_SERVE_BATCH, TP_SERVE_PROMPT))}
    P = 0
    if cfg.frontend:
        P = cfg.frontend_seq
        x["frontend_embeds"] = (0.1 * np.random.default_rng(1).standard_normal(
            (TP_SERVE_BATCH, P, cfg.frontend_dim))).astype(np.float32)
    return cfg, x, steps, P


def _tp_serve_batch(cfg, x, dev):
    return {k: (torch.from_numpy(np.asarray(v, np.int64)) if k == "tokens"
                else torch.from_numpy(v).to(getattr(torch, cfg.dtype))
                ).to(dev) for k, v in x.items()}


def _tp_serve_shapes(cfg, steps: int, P: int):
    from repro_torch.configs import SHAPES
    pre = dataclasses.replace(SHAPES[0], kind="prefill",
                              seq_len=TP_SERVE_PROMPT,
                              global_batch=TP_SERVE_BATCH)
    dec = dataclasses.replace(SHAPES[0], kind="decode",
                              seq_len=TP_SERVE_PROMPT + P + steps,
                              global_batch=TP_SERVE_BATCH)
    return pre, dec


def _tp_serve_rules(decode: bool):
    from repro_torch.sharding import ShardingRules
    return ShardingRules(data_axes=("data",), sequence_parallel=not decode)


def tp_serve_oracle(root: str, arch: str) -> dict:
    """`Model.prefill` and `Model.decode_step` of the bf16 serving params
    on the whole model in this process (the programs on a mesh of one
    rank): the prefill, then `steps` decode steps each fed the oracle's
    own greedy token; the logits of every step and the cache after the
    prefill and after the last step saved under `root`, the tokens apart
    for the ranks; beside them the f32 truth, the same params and tokens
    at f32 compute, which the ranks' and the oracle's bf16 distances are
    read against. Returns prefill ms, decode ms per step and the peak."""
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg, x, steps, P = tp_serve_setup(arch)
    model = build_model(cfg, "cuda")
    params = dryrun._half_params(model.init(seed=0))
    batch = _tp_serve_batch(cfg, x, "cuda")
    T = TP_SERVE_PROMPT + P + steps
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, T)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        out = [logits.float().cpu()]
        pre_cache = {k: v.to("cpu", copy=True) for k, v in cache.items()}
        toks, ms = [], []
        for i in range(steps):
            tok = logits.argmax(-1)
            toks.append(tok.cpu())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok,
                                              TP_SERVE_PROMPT + P + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float().cpu())
    peak = _peak_gib(base) + base / 2 ** 30
    end = {k: v.cpu() for k, v in cache.items()}
    del cache, logits, model
    # the f32 truth: the same bf16 params and tokens at f32 compute
    cfg32 = dataclasses.replace(cfg, dtype="float32", attention_impl="xla")
    model32 = build_model(cfg32, "cuda")
    params = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        lg, cache = model32.prefill(params, _tp_serve_batch(cfg32, x, "cuda"),
                                    T)
        truth = [lg.cpu()]
        for i, tok in enumerate(toks):
            lg, cache = model32.decode_step(params, cache, tok.to("cuda"),
                                            TP_SERVE_PROMPT + P + i)
            truth.append(lg.cpu())
    torch.save(torch.stack(toks), os.path.join(root, f"tokens_{arch}.pt"))
    torch.save({"logits": torch.stack(out), "pre": pre_cache, "end": end,
                "truth": torch.stack(truth)},
               os.path.join(root, f"oracle_{arch}.pt"))
    del model32, params, cache, lg
    _free()
    torch.cuda.empty_cache()
    return {"prefill_ms": pre_ms, "decode_ms": ms, "peak_gib": peak}


def _bf16_np(t):
    """A bf16 tensor's bits as numpy int16 (numpy has no bf16)."""
    return t.detach().contiguous().view(torch.int16).cpu().numpy()


def _from_bf16_np(a):
    return torch.from_numpy(a).view(torch.bfloat16)


def tp_serve_run(cfg, x, steps: int, P: int, mesh, toks, repeat: int) -> dict:
    """One mesh's runs on this rank: `build_prefill_program` (SP on, a
    cache of prompt + steps rows) and `build_decode_program` on the rank's
    block of the bf16 params, its rows of the batch and of each step's
    token; `repeat` times the prefill and every step. Per run the prefill
    ms, decode ms per step, the collectives, bytes received and host
    seconds in them by label, K2's launches by shape; the first run's
    logits blocks and its cache block after the prefill and the last step
    (bf16 bits), and whether every other run gave the same bits."""
    from repro_torch.core import hostsync
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.sharding import Resolver
    from repro_torch.tree import leaves, tree_map

    dev = torch.device("cuda")
    t_setup = time.perf_counter()
    pre_shape, dec_shape = _tp_serve_shapes(cfg, steps, P)
    T = TP_SERVE_PROMPT + P + steps
    pre, _ = dryrun.build_prefill_program(
        cfg, pre_shape, mesh, Resolver(mesh, _tp_serve_rules(False)),
        max_len=T)
    dec, _ = dryrun.build_decode_program(
        cfg, dec_shape, mesh, Resolver(mesh, _tp_serve_rules(True)))
    full = build_model(cfg, dev).init(seed=0)
    params = tree_map(lambda t: t.clone(), pre.shard_params(full))
    del full
    _free()
    torch.cuda.empty_cache()
    batch = pre.shard_batch(_tp_serve_batch(cfg, x, dev))
    tok = [dec.shard_batch({"t": t.to(dev)})["t"] for t in toks]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = {"param_bytes": sum(t.numel() * t.element_size()
                              for t in leaves(params)),
           "coords": {"data": mesh.data, "model": mesh.model}, "runs": [],
           "setup_s": time.perf_counter() - t_setup}
    first = None
    for r in range(repeat):
        run = {}
        kfa.launch_count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with hostsync.count_transfers() as st:
            logits, cache = pre(params, batch)
            torch.cuda.synchronize()
        run["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        run["k2"] = (kfa.launch_count.n, dict(kfa.launch_count.shapes))
        run["prefill"] = (dict(st.collectives), dict(st.collective_bytes),
                          dict(st.collective_seconds))
        rec["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for t in leaves(cache))
        out = [logits.float().cpu()]
        pre_cache = {k: v.clone() for k, v in cache.items()}
        run["decode_ms"], run["decode"] = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hostsync.count_transfers() as st:
                logits, cache = dec(params, cache, tok[i],
                                    TP_SERVE_PROMPT + P + i)
                torch.cuda.synchronize()
            run["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            run["decode"].append((dict(st.collectives),
                                  dict(st.collective_bytes),
                                  dict(st.collective_seconds)))
            out.append(logits.float().cpu())
        bits = (torch.stack(out), pre_cache, cache)
        if first is None:
            first = bits
            rec["logits"] = bits[0].numpy()
            rec["cache_pre"] = {k: _bf16_np(v) for k, v in pre_cache.items()}
            rec["cache_end"] = {k: _bf16_np(v) for k, v in cache.items()}
        else:
            run["bitwise"] = (torch.equal(bits[0], first[0]) and all(
                torch.equal(bits[j][k], first[j][k])
                for j in (1, 2) for k in first[1]))
        rec["runs"].append(run)
        del logits, cache, pre_cache, out
    rec["peak_gib"] = _peak_gib(base) + base / 2 ** 30
    del params, first
    _free()
    torch.cuda.empty_cache()
    return rec


def tp_serve_rank(rank: int, root: str) -> dict:
    """One rank of phase tp_serve (spawned by `launch/mesh.py::spawn`):
    each run of TP_SERVE_RUNS (`tp_serve_run`), qwen2-0.5b's twice (the
    bits of two runs compared), the oracle's greedy tokens fed at every
    step."""
    from repro_torch.configs import MeshConfig
    from repro_torch.device import make_deterministic
    from repro_torch.launch.mesh import make_process_mesh

    make_deterministic(torch.device("cuda"))
    out = {}
    for arch, name, shape in TP_SERVE_RUNS:
        cfg, x, steps, P = tp_serve_setup(arch)
        mesh = make_process_mesh(MeshConfig(shape=shape,
                                            axis_names=("data", "model")))
        toks = torch.load(os.path.join(root, f"tokens_{arch}.pt"))
        out[f"{arch}/{name}"] = tp_serve_run(
            cfg, x, steps, P, mesh, toks,
            repeat=2 if arch == "qwen2-0.5b" else 1)
    return out


def tp_serve_collectives(cfg, name: str, M: int):
    """(one prefill's, one decode step's) collectives by label on a run of
    TP_SERVE_RUNS, as the code places them (L layers; SP on in prefill,
    off in decode). (a), (data, model) = (2, 2): the FSDP gathers (a
    bucket a layer; the lookup, the head and the final norm); prefill per
    layer the attention's and the MLP's SP gather and reduce-scatter, the
    vocab-parallel lookup's reduce-scatter where the vocab splits, the
    last position's gather; decode per layer the two exit sums and the
    lookup's sum where the vocab splits. (b), (1, 4), 14 heads and 2 kv
    heads over 4 ranks: prefill by rows (batch_dm) with the attention's 7
    weights gathered from their head-dim blocks, its entry and exit and
    the MLP's entry gathers, the MLP's reduce-scatter, the lookup's, the
    last position's gather and one `tp_cache`; decode by head dims: per
    layer `tp_rope`, `tp_scores` and the two exit sums, the lookup's
    sum."""
    L = cfg.num_layers
    vp = int(cfg.vocab_size % M == 0)
    if name == "b":
        return ({"tp_gather": 10 * L + 1, "tp_scatter": L + 1,
                 "tp_cache": 1},
                {"tp_reduce": 2 * L + 1, "tp_rope": L, "tp_scores": L})
    pre = {"fsdp_gather": L + 3, "tp_gather": 2 * L + 1,
           "tp_scatter": 2 * L + vp}
    dec = {"fsdp_gather": L + 3, "tp_reduce": 2 * L + vp}
    return pre, dec


def tp_serve_k2_shape(cfg, name: str, shape) -> tuple:
    """The K2 launch key (`launch_count.shapes`) of a rank's prefill on a
    run: (a) the rank's rows (B / data) and heads (H / model); (b), where
    the heads do not split, one row per rank with every head."""
    D, M = shape
    B = TP_SERVE_BATCH // D
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H % M:
        B //= M
    else:
        H, KV = H // M, KV // M
    S = TP_SERVE_PROMPT + (cfg.frontend_seq if cfg.frontend else 0)
    return (B, H, KV, S, S, cfg.head_dim, 1, 0, torch.bfloat16)


def phase_tp_serve(kfa) -> list:
    """Slice 16: the sharded serving programs (`launch/dryrun.py::
    build_prefill_program`, `build_decode_program`) on 4 ranks of this one
    card over gloo, each run of TP_SERVE_RUNS (`tp_serve_rank`) against the
    one-process oracle (`tp_serve_oracle`, freed before the ranks start):
    qwen2-0.5b at full width and depth, (a) (data, model) = (2, 2): the
    prefill under SP with 7 q heads and 1 kv head per rank, the decode by
    kv heads, FSDP gathers of the weights at every step; (b) (1, 4): the
    prefill by rows (14 heads do not split over 4), the decode by blocks
    of 16 of the 64 head dims; internvl2-2b (vlm, 1 layer) on (a), its
    vocab whole. Every step's logits, gathered over the vocab, within
    TP_SERVE_TOL of each row's max |logit|, the top-1 token the oracle's
    wherever its top-2 margin exceeds twice that; the cache after the
    prefill and after the last step within TP_SERVE_TOL of each leaf's max
    and, qwen2's, bitwise equal over two runs; the collectives per prefill
    and per step as `tp_serve_collectives` states them; each rank's params
    and cache bytes as `dryrun.plan_ranks` plans them; K2 launched once
    per layer per rank and prefill at the rank's shape, then held against
    its plain version there (`family_k2`). Prints prefill ms, decode
    ms/step, the peak per rank, gloo bytes per step and host seconds in
    collectives by label. Returns the K2 kernel-line entries, one per
    rank shape, with their launches."""
    import tempfile

    from repro_torch.configs import MeshConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import local_mesh, spawn
    from repro_torch.sharding import Resolver

    t_phase = time.time()
    _free()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="sedar_tp_serve_")
    orc = {}
    for arch in dict.fromkeys(a for a, _, _ in TP_SERVE_RUNS):
        orc[arch] = tp_serve_oracle(root, arch)
        o = orc[arch]
        print(f"tp_serve: oracle {arch} (one process): prefill "
              f"{o['prefill_ms']:.1f} ms, decode ms/step "
              f"{', '.join(f'{t:.1f}' for t in o['decode_ms'])}, peak "
              f"{o['peak_gib']:.2f} GiB", flush=True)
    t_spawn = time.time()
    reps = spawn(tp_serve_rank, 4, root, threads=TP_THREADS,
                 timeout_s=TP_SERVE_TIMEOUT_S)
    print(f"tp_serve: 4 ranks took {time.time() - t_spawn:.1f} s, spawn "
          "included", flush=True)
    bad, k2_shapes = [], {}

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            print(f"tp_serve: FAILED {msg}", flush=True)
            bad.append(msg)
    one = local_mesh(MeshConfig(shape=(1, 1), axis_names=("data", "model")))
    for arch, name, shape in TP_SERVE_RUNS:
        cfg, x, steps, P = tp_serve_setup(arch)
        key = f"{arch}/{name}"
        sizes = dict(zip(("data", "model"), shape))
        _, dec_shape = _tp_serve_shapes(cfg, steps, P)
        gather = dryrun.build_decode_program(
            cfg, dec_shape, one, Resolver(sizes, _tp_serve_rules(True)),
            device="cpu")[0]
        want = torch.load(os.path.join(root, f"oracle_{arch}.pt"))
        recs = [rep[key] for rep in reps]
        gaps, flips, to_truth = [], 0, [0.0, 0.0]
        for s in range(steps + 1):
            got = gather.gather_logits(
                [torch.from_numpy(r["logits"][s]) for r in recs])
            w = want["logits"][s]
            top = w.abs().amax(-1)
            gaps.append(float(((got - w).abs().amax(-1) / top).max()))
            t = want["truth"][s]
            for j, a in enumerate((got, w)):
                to_truth[j] = max(to_truth[j], float((
                    (a - t).abs().amax(-1) / t.abs().amax(-1)).max()))
            two = torch.topk(w, 2, dim=-1).values
            sure = (two[:, 0] - two[:, 1]) > 2 * TP_SERVE_TOL * top
            flips += int((sure & (got.argmax(-1) != w.argmax(-1))).sum())
        cache_gap = {}
        for part in ("pre", "end"):
            got = gather.gather_cache([{k: _from_bf16_np(v) for k, v in
                                        r[f"cache_{part}"].items()}
                                       for r in recs])
            cache_gap[part] = max(
                float((got[k].float() - want[part][k].float()).abs().max()
                      / want[part][k].float().abs().max()) for k in got)
        print(f"tp_serve {key} {shape}: logits vs the oracle, worst row "
              f"per step {', '.join(f'{g:.3e}' for g in gaps)} of its max "
              f"|logit|; top-1 differing where the oracle's margin is sure: "
              f"{flips}; cache after prefill {cache_gap['pre']:.3e}, after "
              f"the last step {cache_gap['end']:.3e} of a leaf's max; to the "
              f"f32 forward of the same params: the ranks {to_truth[0]:.3e}, "
              f"the oracle {to_truth[1]:.3e}", flush=True)
        expect(max(gaps) <= TP_SERVE_TOL and flips == 0
               and max(cache_gap.values()) <= TP_SERVE_TOL,
               f"{key}: logits {max(gaps)}, flips {flips}, cache "
               f"{cache_gap} off the oracle (bound {TP_SERVE_TOL})")
        plan = dryrun.plan_ranks(cfg, sizes, _tp_serve_rules(True),
                                 shape=dec_shape)
        want_pre, want_dec = tp_serve_collectives(cfg, name, shape[1])
        k2_key = tp_serve_k2_shape(cfg, name, shape)
        for r, rec in enumerate(recs):
            rank = plan["ranks"][r]
            expect(rec["param_bytes"] == rank["serve_param_bytes"]
                   and rec["cache_bytes"] == rank["cache_bytes"],
                   f"{key}: rank {r} holds params {rec['param_bytes']} B, "
                   f"cache {rec['cache_bytes']} B; plan_ranks {rank}")
            for i, run in enumerate(rec["runs"]):
                expect(run["prefill"][0] == want_pre,
                       f"{key}: rank {r} run {i} prefill collectives "
                       f"{run['prefill'][0]}, the code implies {want_pre}")
                for s, d in enumerate(run["decode"]):
                    expect(d[0] == want_dec,
                           f"{key}: rank {r} run {i} step {s} collectives "
                           f"{d[0]}, the code implies {want_dec}")
                n, by_shape = run["k2"]
                expect(n == cfg.num_layers
                       and by_shape == {k2_key: cfg.num_layers},
                       f"{key}: rank {r} K2 launches {n} {by_shape}, want "
                       f"{cfg.num_layers} at {k2_key}")
                k2_shapes[k2_key] = k2_shapes.get(k2_key, 0) + n
                if "bitwise" in run:
                    expect(run["bitwise"], f"{key}: rank {r} run {i}'s "
                           "logits or cache bits differ from run 0's")
            run = rec["runs"][-1]
            gib = [sum(d[1].values()) / 2 ** 30 for d in run["decode"]]
            secs = run["decode"][-1][2]
            print(f"tp_serve {key}: rank {r} {rec['coords']}: prefill "
                  + ", ".join(f"{q['prefill_ms']:.1f}" for q in rec["runs"])
                  + " ms; decode ms/step " + ", ".join(
                      f"{t:.1f}" for t in run["decode_ms"]) + "; "
                  f"peak {rec['peak_gib']:.2f} GiB; params "
                  f"{rec['param_bytes']} B, cache {rec['cache_bytes']} B; "
                  f"gloo GiB received: prefill "
                  f"{sum(run['prefill'][1].values()) / 2 ** 30:.4f}, per "
                  f"step {gib[-1]:.4f}; host s in collectives, last step "
                  f"{sum(secs.values()):.3f}: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(
                          secs.items(), key=lambda kv: -kv[1]))
                  + f"; bitwise over runs "
                  f"{[q.get('bitwise', True) for q in rec['runs']]}; "
                  f"setup (programs, params) {rec['setup_s']:.1f} s",
                  flush=True)
        print(f"tp_serve {key}: collectives per prefill {want_pre}, per "
              f"decode step {want_dec}; plan_ranks per rank "
              f"{plan['ranks'][0]}, whole {plan['whole']}", flush=True)
    # K2 at each rank shape the phase launched, against its plain version
    entries = []
    for (B, H, KV, S, _, hd, _, _, _), n in k2_shapes.items():
        arch = "internvl2-2b" if hd == 128 else "qwen2-0.5b"
        cfg = dataclasses.replace(tp_serve_setup(arch)[0], num_heads=H,
                                  num_kv_heads=KV)
        e = family_k2(kfa, cfg, B, S, f"tp_serve_rank_B{B}_H{H}_KV{KV}",
                      window=0)
        e["launches"] = n
        entries.append(e)
    print(f"tp_serve phase took {time.time() - t_phase:.1f} s", flush=True)
    check(not bad, "; ".join(bad[:8]))
    return entries


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


PHASES = ("k1", "k2", "k3", "campaign", "scenarios", "engine", "k4",
          "f32_wide", "main", "abft_serve", "serve", "telemetry", "families",
          "f32_generate", "family_serve", "train", "pod_train",
          "elastic_train", "pod_elastic", "family_train", "chunked", "remat",
          "plan", "ep", "tp", "tp_serve", "f3_xlstm", "reference")
# what a phase takes from another's run
PHASE_NEEDS = {"abft_serve": ("main",), "serve": ("main",),
               "telemetry": ("main", "serve"), "f32_generate": ("f32_wide",),
               "pod_train": ("train",), "elastic_train": ("train",),
               "pod_elastic": ("train",), "plan": ("remat", "chunked")}


def selected_phases(argv):
    """`--phases a,b,...`: those phases and what they need (PHASE_NEEDS),
    or None (every phase) without the flag."""
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (and what they "
                    f"need) of: {', '.join(PHASES)}; default: all")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    todo = [p for p in args.phases.split(",") if p]
    unknown = [p for p in todo if p not in PHASES]
    if unknown:
        fail(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    chosen = set()
    while todo:
        p = todo.pop()
        if p not in chosen:
            chosen.add(p)
            todo.extend(PHASE_NEEDS.get(p, ()))
    return chosen


def main() -> None:
    t_start = time.time()
    if sys.argv[1:2] == ["--plan-cells"]:    # phase plan's child process
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, os.path.join(here, "src"))
        plan_cells(sys.argv[2])
        return
    phases = selected_phases(sys.argv[1:])
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

    # phase plan's dry-run cells run on the host's CPU meanwhile
    plan = start_plan() if phases is None or "plan" in phases else None
    t_last = [time.time()]

    def mark(what: str) -> None:
        """One line per phase group: its seconds and the script's so far
        (the depth cuts of PERF.md section 4 are budgeted from these)."""
        now = time.time()
        print(f"[phase time] {what}: {now - t_last[0]:.1f} s (script "
              f"{now - t_start:.1f} s)", flush=True)
        t_last[0] = now

    def want(name: str) -> bool:
        return phases is None or name in phases

    zero = {"fingerprint": 0, "flash_attention": 0}
    k1 = phase_k1(kfp) if want("k1") else None
    k2 = phase_k2(kfa) if want("k2") else None
    k3 = phase_k3(kab) if want("k3") else None
    if want("campaign"):
        phase_campaign(kab)
    campaign_k1 = phase_scenarios(kfp) if want("scenarios") else 0
    if want("engine"):
        launches = phase_engine(kab)
        if k3 is not None:
            k3["launches"] = launches
    k4 = phase_k4(kab, kfa, report) if want("k4") else None
    k2_f32, k4_wide = (phase_f32_wide(kab, kfa, report) if want("f32_wide")
                       else ({}, []))
    mark("K1, K2, K3, campaign, scenarios, engine, K4, f32_wide")
    counts, main_run = zero, None
    if want("main"):
        counts, main_run = phase_main(kfp, kfa, get_config("qwen2-0.5b"))
    if want("abft_serve"):
        phase_abft_serve(kfp, kfa, main_run)
    mark("main, abft serving")
    serve_counts, served = {}, None
    if want("serve"):
        serve_counts, served = phase_serve(kfp, kfa, main_run)
    mark("serve")
    telemetry_counts = {}
    if want("telemetry"):
        telemetry_counts = phase_telemetry_serve(kfp, kfa, main_run, served)
    del main_run, served
    _free()
    mark("telemetry (serving)")
    families_k1, wide_k2 = (phase_families(kfp, kfa) if want("families")
                            else (0, []))
    _free()
    mark("families")
    if want("f32_generate"):
        for hd, n in phase_f32_generate(kfp, kfa).items():
            k2_f32[hd]["launches"] = n
    _free()
    mark("f32_generate")
    family_serve, serve_k2 = (phase_family_serve(kfp, kfa)
                              if want("family_serve") else ({}, []))
    mark("family_serve")
    kfp.launch_count.reset()
    train_k1, lanes = 0, None
    if want("train"):
        train_k1, lanes, seq_losses, seq_final = phase_train(kfp)
        check(train_k1 > 0, "K1 never launched by the trainer")
    _free()
    mark("train (its tiers and telemetry included)")
    if want("pod_train"):
        lanes["launches"] = phase_pod_train(kfp, seq_losses, seq_final)
    _free()
    mark("pod_train")
    elastic_k1 = (phase_elastic_train(kfp, seq_losses, seq_final)
                  if want("elastic_train") else 0)
    _free()
    mark("elastic_train")
    if want("pod_elastic"):
        lanes["launches"] += phase_pod_elastic(kfp)
    _free()
    mark("pod_elastic")
    family_train_k1 = 0
    if want("family_train"):
        family_train_k1 = phase_family_train(kfp)
        check(family_train_k1 > 0, "K1 never launched by the family trainers")
    mark("family_train")
    chunked_k1, chunked_runs = (phase_chunked(kfp) if want("chunked")
                                else (0, {}))
    _free()
    mark("chunked")
    remat_runs = phase_remat(kfp) if want("remat") else {}
    remat_k1 = sum(r["k1"] for r in remat_runs.values())
    _free()
    mark("remat")
    if want("plan"):
        phase_plan(remat_runs, chunked_runs, plan)
    mark("plan")
    if want("ep"):
        phase_ep()
    mark("ep")
    tp_k1 = phase_tp() if want("tp") else 0
    _free()
    mark("tp")
    serve_tp_k2 = phase_tp_serve(kfa) if want("tp_serve") else []
    _free()
    mark("tp_serve")
    if want("f3_xlstm"):
        phase_f3_xlstm(kfp, kfa)
    _free()
    mark("f3_xlstm")
    if want("reference"):
        phase_reference()
    # the main path's K1 launches, the training paths' and the replica
    # campaign's, each counted from 0 just before its run
    if k1 is not None:
        k1["launches"] = (counts["fingerprint"] + train_k1 + campaign_k1
                          + families_k1 + family_train_k1 + elastic_k1
                          + chunked_k1 + remat_k1
                          + sum(c["fingerprint"]
                                for c in family_serve.values()))
    # the sharded program's K1 lanes (one lane per rank and step), in the
    # lanes entry (phase train's), else in K1's
    entry = lanes if lanes is not None else k1
    if tp_k1 and entry is not None:
        entry["launches"] = entry.get("launches", 0) + tp_k1
    if k2 is not None:
        k2["launches"] = counts["flash_attention"]
    k2_all = [e for e in (k2, *wide_k2, *serve_k2, *serve_tp_k2,
                          *k2_f32.values())
              if e is not None and "launches" in e]
    print("K2 launches: " + ", ".join(
        f"{e['name']} {e['launches']}" for e in k2_all), flush=True)
    kernels = [k for k in (k1, lanes, k2, *wide_k2, *serve_k2, *serve_tp_k2,
                           *k2_f32.values(), k3, k4, *k4_wide)
               if k is not None]
    if phases is None:      # every path ran: every kernel launched on it
        for k in kernels:
            check(k["launches"] > 0, f"kernel {k['name']} never launched")
        for k, n in serve_counts.items():
            check(n > 0, f"kernel {k} never launched by serve()")
        for arch, c in family_serve.items():
            check(c["fingerprint"] > 0 and (c["flash_attention"] > 0
                                            or arch.startswith("xlstm")),
                  f"{arch} serve(): launches {c}")
        for k, n in telemetry_counts.items():
            check(n > 0, f"kernel {k} never launched with telemetry on")
    else:
        kernels = [k for k in kernels if "launches" in k]
    print(f"chip smoke took {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
