"""Serving launcher, synchronous whole-batch decode (the reference's
`launch/serve.py::_sync`, same flags):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --steps 16 [--dual | --backend abft] [--device cpu]

As in the reference, `--smoke` is a store_true flag that defaults to True,
so the launcher always runs the reduced configuration; the full-width run is
driven through the API (`chip_smoke.py`). It runs on the card unless
`--device cpu` is given. `--backend` picks the protection
(none/sequential/abft/hybrid; `--dual` alone means sequential), which the
reference offers only on its continuous replay. The continuous-batching
replay (`--continuous`) comes with a later slice.
"""
from __future__ import annotations

import argparse
import os


def main() -> None:
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--dual", action="store_true",
                    help="SEDAR dual-execution detection on decode")
    ap.add_argument("--backend", default=None,
                    choices=["none", "sequential", "abft", "hybrid"],
                    help="protection backend (default: sequential with "
                         "--dual, else none)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    # deterministic cuBLAS needs this before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np

    from repro_torch.configs import (RunConfig, TrainConfig, get_config,
                                     reduce_for_smoke)
    from repro_torch.core.policy import make_server

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    srv = make_server(RunConfig(model=cfg, train=TrainConfig()),
                      dual=args.dual, backend=args.backend,
                      device=args.device)
    params = srv.model.init(seed=0)
    prompts = {"tokens": np.random.RandomState(0).randint(
        0, min(cfg.vocab_size, 200), (args.batch, args.prompt_len))}
    toks, rep = srv.generate(params, prompts, steps=args.steps)
    tps = rep.tokens_emitted / max(rep.wall_s, 1e-9)
    where = (f"on {__import__('torch').cuda.get_device_name(0)}"
             if srv.device.type == "cuda" else "on the CPU")
    print(f"{args.arch}: {rep.tokens_emitted} tokens, {tps:.1f} tok/s "
          f"({where}), backend={srv.backend}, "
          f"detections={len(rep.detections)}")


if __name__ == "__main__":
    main()
