"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc` (one nvcc per
source, in parallel) and holds each kernel against its plain PyTorch version
on the card. Then it drives the port's paths, each with the kernels' launch
counts set to 0 just before it and read just after:

  * the main path — protected dual-replica `SedarServer.generate` of
    qwen2-0.5b at full width with seeded random weights, prefill attention
    through the flash kernel K2, commit compares through K1: a clean run
    has no detection and emits the unprotected run's tokens, an injected
    bit flip is detected and retried without changing the tokens;
  * the ABFT slice — the checksummed matmul K3 through `abft_matmul`
    (the 12-scenario campaign, and `SedarEngine` + `AbftExecutor` with a
    forward correction and a retry), the checksummed flash attention K4
    through `abft_flash_attention` at the model's prefill shapes, and the
    replica-free `abft`/`hybrid` serving of the same model (clean runs equal
    the unprotected tokens; a kernel fault is corrected forward);
  * a small f32 model on the card against the plain CPU path.

Any failed check exits non-zero. The last two lines are a JSON object of
kernel numbers and the result line.

Numbers: a kernel's time (`ms` in the kernels line), its plain version's
and the library call's are device times: the kernels each call launches,
summed by torch.profiler over many warm calls (deterministic mode's fills
of fresh outputs left out), per call. Beside them the K1, K2 and K3 lines
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
    """Mean device time per call of fn(): the kernels it launches, summed
    from torch.profiler, without deterministic mode's fills of fresh
    outputs. Unlike cuda_ms it leaves out the host's time between launches,
    which sets cuda_ms for a kernel of a few microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "fill" not in e.key.lower())
    check(busy > 0, "the profiler saw no device time")
    return busy / 1e3 / iters


def bound(bytes_: float, ops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k1(kfp):
    """K1 against its plain version: hash words and absmax bitwise, the sum
    close. Returns the kernels-line entry; its max_abs_err is the largest
    |kernel - plain| over the four result words at every size (the hash
    words and absmax are checked equal, so it is the sum word's error)."""
    dev = torch.device("cuda")
    sizes = [0, 1, 127, 128 * 256 + 1, BATCH * 151_936, 100_000_000]
    max_err = 0.0
    for n in sizes:
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn(n, generator=gen, device=dev) * 3
        u = x.view(torch.int32)
        got = kfp.fingerprint_u32(u).cpu().numpy().view(np.uint32)
        want = kfp.fingerprint_plain(u).cpu().numpy().view(np.uint32)
        check(np.array_equal(got[:2], want[:2]),
              f"K1 hash words differ from plain at n={n}: {got} vs {want}")
        check(got[3] == want[3], f"K1 absmax differs at n={n}")
        gs, ga = (float(v) for v in got[2:].view(np.float32))
        ws, wa = (float(v) for v in want[2:].view(np.float32))
        dh = int(np.abs(got[:2].astype(np.int64) - want[:2].astype(np.int64))
                 .max())
        err = max(float(dh), abs(gs - ws), abs(ga - wa))
        max_err = max(max_err, err)
        scale = max(float(x.abs().sum()), 1.0)
        check(abs(gs - ws) <= 1e-5 * scale, f"K1 sum off at n={n}: {gs} {ws}")
        print(f"K1 n={n}: h1/h2/absmax bitwise equal to plain, sum "
              f"|ds|={abs(gs - ws):.3e} (|ds|/sum|x|={abs(gs - ws) / scale:.3e})",
              flush=True)
    n = BATCH * 151_936
    u = (torch.randn(n, device=dev) * 3).view(torch.int32)
    call_ms = cuda_ms(lambda: kfp.fingerprint_u32(u), 200)
    ms = device_ms(lambda: kfp.fingerprint_u32(u), 200)
    plain_ms = device_ms(lambda: kfp.fingerprint_plain(u), 20)
    big = (torch.randn(100_000_000, device=dev)).view(torch.int32)
    big_ms = device_ms(lambda: kfp.fingerprint_u32(big), 20)
    b_ms, b_by = bound(4 * n + 16, 0)
    print(f"K1 at n={n} (B={BATCH} logits): device {ms:.4f} ms (per call "
          f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); at n=1e8: {big_ms:.4f} ms = {4e8 / big_ms / 1e9:.3f} "
          f"TB/s; max |kernel - plain| over the result words {max_err:.3e}",
          flush=True)
    return {"name": "fingerprint", "route": "cuda",
            "source": "src/repro_torch/csrc/fingerprint.cu",
            "replaces": "src/repro/kernels/fingerprint.py:51",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_k2(kfa):
    """K2 against its plain version in bf16 at qwen2-0.5b prefill shapes:
    elementwise within atol 1e-3 + rtol 8e-3 (one bf16 rounding step is at
    most 2^-7 of the value), each row within 1e-2 of its largest output, and
    two launches bitwise equal."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    H, KV, hd = 14, 2, 64
    entry = None
    for S in (PROMPT_LEN, 2048):
        gen = torch.Generator(device=dev).manual_seed(S)
        # model layout (B, S, heads, hd), viewed as (B, heads, S, hd) as the
        # model's prefill passes it
        q = torch.randn(BATCH, S, H, hd, generator=gen, device=dev,
                        dtype=torch.bfloat16).transpose(1, 2)
        k = torch.randn(BATCH, S, KV, hd, generator=gen, device=dev,
                        dtype=torch.bfloat16).transpose(1, 2)
        v = torch.randn(BATCH, S, KV, hd, generator=gen, device=dev,
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
        check(bool(torch.isfinite(got).all()), f"K2 non-finite at S={S}")
        check(over <= 0, f"K2 off plain beyond atol 1e-3 + rtol 8e-3 at "
              f"S={S} (max abs err {err})")
        check(row_err <= 1e-2,
              f"K2 max error per row's largest value {row_err} > 1e-2 at S={S}")
        check(torch.equal(got, again), f"K2 not bitwise repeatable at S={S}")
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

    logits, _ = srv.model.prefill(params, {"tokens": prompt}, PROMPT_LEN + 8)
    check(tuple(logits.shape) == (BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits shape {tuple(logits.shape)} or not finite")
    phase_profile(srv, params, prompt, "a dual")
    return counts, {"cfg": cfg, "params": params, "prompt": prompt,
                    "tokens": toks}


def device_profile(fn):
    """Run fn() once under torch.profiler (which itself slows the host).
    Returns (wall ms, device-busy ms, kernel launches, per-kernel events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    return wall_ms, busy_ms, sum(e.count for e in kern), kern


def phase_profile(srv, params, prompt, label: str, steps: int = 17):
    """Where a protected generate's time goes: device-busy share of the
    wall and the kernels that take the device time."""
    wall_ms, busy_ms, launches, kern = device_profile(
        lambda: srv.generate(params, {"tokens": prompt}, steps=steps))
    print(f"profile of {label} generate ({steps - 1} decode steps, "
          f"profiler on): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
          f" ({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches "
          f"({launches / (steps - 1):.0f} per decode step incl. prefill)",
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
        wall_ms, busy_ms, launches, _ = device_profile(checksummed)
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


def phase_k4(kab, kfa):
    """K4 against its plain version (flash_attention_plain on the encoded V)
    in f32 at qwen2-0.5b prefill shapes and the checksum verdicts; then
    the API `abft_flash_attention` 24 times on the S=256 inputs, held
    against its oracle `abft_attention_ref`. No model path calls K4, in the
    port or in the reference: its counted launches are these API calls."""
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
        print(f"K4 S={S}: max abs err {err:.3e} vs plain (f32), clean "
              f"verify detected {bool(rep.detected)}, bit-23 flip of the "
              f"largest output: detected {bool(frep.detected)}, "
              f"uncorrectable {bool(frep.uncorrectable)}", flush=True)
        check(bool(torch.isfinite(got).all()), f"K4 non-finite at S={S}")
        check(over <= 1e-5, f"K4 off plain beyond atol 1e-5 + rtol 1e-5 at "
              f"S={S} (max abs err {err})")
        check(not bool(rep.detected), f"clean K4 output detected at S={S}")
        check(bool(frep.detected) and bool(frep.uncorrectable),
              f"K4 output fault not detected as uncorrectable at S={S}")
        ms = device_ms(lambda: kab.flash_attention_ck(q, k, v_aug,
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
        print(f"K4 S={S}: device {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa f32 on "
              f"(q, k, v_aug) {lib_ms if lib_ms is None else f'{lib_ms:.4f}'}"
              f" ms (backend that took hd+1 with GQA: {lib_backend}), bound "
              f"{b_ms:.5f} ms ({b_by}, f32 rate), "
              f"{flops / ms / 1e9:.2f} TFLOP/s achieved", flush=True)
        if S == PROMPT_LEN:
            entry = {"name": "abft_flash_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/abft/kernels.py:122",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            path = (q, k, v)
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

    # decode ms/step of the four backends, in turns (ABBA), so that the
    # shared host's drift hits each alike
    servers = {b: make_server(rc, backend=b, device=dev)
               for b in ("none", "sequential", "abft", "hybrid")}
    times = {}
    for b in list(servers) + list(servers)[::-1]:
        _, rep = servers[b].generate(params, {"tokens": prompt}, steps=STEPS)
        times.setdefault(b, []).append(decode_ms(rep))
    print("decode ms/step, same call, in turns none, sequential (dual), "
          "abft, hybrid, then back: " + "; ".join(
              f"{b} {' / '.join(f'{t:.2f}' for t in v)}"
              for b, v in times.items()), flush=True)


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
    for kname, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"nvcc {kname}: {line.strip()}")
    print(f"kernels built in {time.time() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})", flush=True)

    k1 = phase_k1(kfp)
    k2 = phase_k2(kfa)
    k3 = phase_k3(kab)
    phase_campaign(kab)
    k3["launches"] = phase_engine(kab)
    k4 = phase_k4(kab, kfa)
    counts, main_run = phase_main(kfp, kfa, get_config("qwen2-0.5b"))
    phase_abft_serve(kfp, kfa, main_run)
    phase_reference()
    k1["launches"] = counts["fingerprint"]
    k2["launches"] = counts["flash_attention"]
    kernels = [k1, k2, k3, k4]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
