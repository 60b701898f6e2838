"""Fused against sequential `generate()` decode, ms/step, on one NVIDIA
GPU, with the port's package taken from SRC:

    python3 scripts/fused_decode_ab.py [SRC] [--arch a,b,...]

SRC defaults to this checkout's `src`. Given another tree's `src` (an
earlier commit unpacked with `git archive` into a git-ignored directory),
it measures that tree's code on the same card; run the trees in turns in
one call (parent, change, change, parent) to compare them. Models:
qwen2-0.5b at full depth (the main path: B = 4, prompt 256) and each case
of `chip_smoke.py::FAMILY_CASES` at its depth, seeded weights, K2
prefill. Each model runs `generate()` of FAMILY_STEPS tokens under
sequential, fused, fused, sequential (one warm-up first) and prints each
run's decode ms/step (host wall, prefill excluded) and fused / sequential
over the two turns (`--arch`: only the models named). Nothing else runs
on the host meanwhile. Prints the card's name and power limit. Imports
nothing of JAX.
"""
import os
import subprocess
import sys

if __name__ == "__main__":
    import argparse
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=os.path.join(here, "src"))
    ap.add_argument("--arch", default=None)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(1, here)
    import chip_smoke as cs       # sets the cuBLAS and allocator env first
    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import repro_torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.policy import make_server
    from repro_torch.device import make_deterministic
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"package: {os.path.dirname(repro_torch.__file__)}", flush=True)
    dev = torch.device("cuda")
    make_deterministic(dev)
    _build.build(["fingerprint", "flash_attention"])
    steps = cs.FAMILY_STEPS
    for arch, B, S, depth in (("qwen2-0.5b", 4, 256, None),
                              *cs.FAMILY_CASES):
        if args.arch and arch not in args.arch.split(","):
            continue
        cfg = cs.cut_depth(dataclasses.replace(
            get_config(arch), attention_impl="pallas"), depth)
        rng = np.random.RandomState(7)
        prompt = {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (B, S))).to(dev)}
        if cfg.frontend:
            prompt["frontend_embeds"] = 0.1 * torch.from_numpy(
                rng.standard_normal((B, cfg.frontend_seq, cfg.frontend_dim)
                                    ).astype(np.float32)).to(dev)
        srv = {b: make_server(RunConfig(model=cfg), backend=b, device=dev)
               for b in ("sequential", "fused")}
        params = srv["sequential"].model.init(seed=0)
        srv["fused"].generate(params, prompt, steps=2)          # warm-up
        ms, toks = {"sequential": [], "fused": []}, {}
        for b in ("sequential", "fused", "fused", "sequential"):
            torch.cuda.synchronize()
            t, rep = srv[b].generate(params, prompt, steps=steps)
            ms[b].append(cs.decode_ms(rep, steps))
            toks.setdefault(b, t)
        ratio = [f / s for f, s in zip(ms["fused"], ms["sequential"])]
        print(f"{arch} ({cfg.family}, {cfg.num_layers} layers, B={B}, "
              f"prompt {S}): decode ms/step sequential "
              f"{ms['sequential'][0]:.2f} / {ms['sequential'][1]:.2f}, fused "
              f"{ms['fused'][0]:.2f} / {ms['fused'][1]:.2f}; fused / "
              f"sequential {ratio[0]:.3f} / {ratio[1]:.3f}; tokens equal "
              f"{np.array_equal(toks['fused'], toks['sequential'])}",
              flush=True)
        del srv, params
        torch.cuda.empty_cache()
