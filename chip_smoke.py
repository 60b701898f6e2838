"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc` (one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version on
the card, then drives the port's main path — protected dual-replica
`SedarServer.generate` of qwen2-0.5b at full width with seeded random
weights, prefill attention through the flash kernel — and checks that the
path went through both kernels (launch counts), that a clean run has no
detection and emits the unprotected run's tokens, that an injected bit flip
is detected and retried without changing the tokens, and that the card
agrees with the plain CPU path on a small input. Any failed check exits
non-zero. The last two lines are a JSON object of kernel numbers and the
result line.

Numbers: kernel times are CUDA-event means over many warm launches; the
bound is max(bytes / 3.35 TB/s, operations / 989 TFLOP/s), the H100 SXM's
published rates, with bytes counting each input read once and each output
written once. Imports nothing of JAX or of the JAX package.
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
PROMPT_LEN = 256
BATCH = 4
STEPS = 32


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


def bound(bytes_: float, ops: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS_PER_S * 1e3
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
    ms = cuda_ms(lambda: kfp.fingerprint_u32(u), 200)
    plain_ms = cuda_ms(lambda: kfp.fingerprint_plain(u), 20)
    big = (torch.randn(100_000_000, device=dev)).view(torch.int32)
    big_ms = cuda_ms(lambda: kfp.fingerprint_u32(big), 20)
    b_ms, b_by = bound(4 * n + 16, 0)
    print(f"K1 at n={n} (B={BATCH} logits): {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, bound {b_ms:.5f} ms ({b_by}); at n=1e8: {big_ms:.4f} ms = "
          f"{4e8 / big_ms / 1e9:.3f} TB/s; max |kernel - plain| over the "
          f"result words {max_err:.3e}", flush=True)
    return {"name": "fingerprint", "route": "cuda",
            "source": "src/repro_torch/csrc/fingerprint.cu",
            "replaces": "src/repro/kernels/fingerprint.py:51",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_k2(kfa):
    """K2 against its plain version in bf16 at qwen2-0.5b prefill shapes."""
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
        want = kfa.flash_attention_plain(q, k, v, causal=True)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        # each row's error against that row's largest output: a late row
        # averages many keys and is small, so an absolute bound alone would
        # let a dropped or misweighted KV tile there pass; one bf16 rounding
        # step of a row's largest value is at most 2^-7 of it
        row_err = float((diff.amax(-1) / want.float().abs().amax(-1)
                         .clamp_min(1e-6)).max())
        check(bool(torch.isfinite(got).all()), f"K2 non-finite at S={S}")
        check(err <= 8e-3, f"K2 max abs error {err} > 8e-3 at S={S}")
        check(row_err <= 1e-2,
              f"K2 max error per row's largest value {row_err} > 1e-2 at S={S}")
        ms = cuda_ms(lambda: kfa.flash_attention_fwd(q, k, v, causal=True),
                     50)
        plain_ms = cuda_ms(
            lambda: kfa.flash_attention_plain(q, k, v, causal=True), 10)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 50)
        pairs = S * (S + 1) // 2                 # unmasked (q, k) pairs
        flops = 4.0 * BATCH * H * hd * pairs     # QK^T and PV
        nbytes = 2.0 * BATCH * S * hd * (2 * H + 2 * KV)
        b_ms, b_by = bound(nbytes, flops)
        print(f"K2 S={S}: max abs err {err:.3e}, per row's largest value "
              f"{row_err:.3e} vs plain (bf16), "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved", flush=True)
        if S == PROMPT_LEN:
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:33",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


def phase_main(kfp, kfa, cfg_full):
    """The main path at full width: clean dual run, unprotected run, fault
    run, then a profile. Returns the launch counts of the clean run."""
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
    decode_ms = (rep.wall_s - rep.prefill_s) / (STEPS - 1) * 1e3
    name = torch.cuda.get_device_name(0)
    print(f"main path on {name}: {rep.tokens_emitted / rep.wall_s:.1f} "
          f"tokens/s ({rep.tokens_emitted} tokens in {rep.wall_s:.3f} s), "
          f"prefill+first token {rep.prefill_s * 1e3:.2f} ms, decode "
          f"{decode_ms:.2f} ms/step (both replicas + compare), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    plain_srv = make_server(RunConfig(model=cfg), dual=False, device=dev)
    ptoks, prep = plain_srv.generate(params, {"tokens": prompt}, steps=STEPS)
    check(np.array_equal(ptoks, toks),
          "dual-replica tokens differ from the unprotected run")
    print(f"unprotected run: same tokens, {prep.tokens_emitted / prep.wall_s:.1f}"
          f" tokens/s, decode {(prep.wall_s - prep.prefill_s) / (STEPS - 1) * 1e3:.2f}"
          f" ms/step", flush=True)

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
    phase_profile(srv, params, prompt)
    return counts


def phase_profile(srv, params, prompt, steps: int = 17):
    """Where a protected generate's time goes: device-busy share of the
    wall (torch.profiler, which itself slows the host) and the kernels that
    take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        srv.generate(params, {"tokens": prompt}, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    print(f"profile of a dual generate ({steps - 1} decode steps, "
          f"profiler on): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
          f" ({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches "
          f"({launches / (steps - 1):.0f} per decode step incl. prefill)",
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


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
    counts = phase_main(kfp, kfa, get_config("qwen2-0.5b"))
    phase_reference()
    k1["launches"] = counts["fingerprint"]
    k2["launches"] = counts["flash_attention"]
    kernels = [k1, k2]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
