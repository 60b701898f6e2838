"""The bf16 grads gap of the sharded training program on the CPU: each
leaf's step-0 grads of `launch/dryrun.py::build_train_program` on 4 gloo
ranks against the same program on a mesh of one rank, at bf16 compute,
with the port's package taken from SRC:

    python3 scripts/sharded_bf16_gap.py [SRC] [--layers 8]

SRC defaults to this checkout's `src`; given another tree's `src` (an
earlier commit unpacked with `git archive` into a git-ignored directory)
it measures that tree's code. The model is qwen2-0.5b reduced as the CPU
tests reduce it (4 / 2 heads, d 128, vocab 256), `--layers` deep, bf16
compute, xla attention, B = 4 x 64 tokens from numpy seed 0, the seed-0
state; the runs: baseline on (data 2, model 2) with sequence parallelism
at microbatches 1 and 2, without it, and sedar on (pod 2, data 1, model
2). Prints, per run, the worst leaves' gap to the one-rank program, to
the f32 grads of the same bf16 half params, and the one-rank program's
own gap to those, each of the leaf's max |g|. Runs on the host's CPU
only; imports nothing of JAX.
"""
import dataclasses
import os
import sys

import numpy as np

B, S, VOCAB = 4, 64, 256
TRAIN = dict(global_batch=B, seq_len=S, warmup_steps=1, steps=10)
RUNS = (("sp_m1", (2, 2), ("data", "model"), "baseline", 1, True),
        ("sp_m2", (2, 2), ("data", "model"), "baseline", 2, True),
        ("no_sp", (2, 2), ("data", "model"), "baseline", 1, False),
        ("sedar", (2, 1, 2), ("pod", "data", "model"), "sedar", 1, False))


def config(layers: int, dtype: str = "bfloat16"):
    from repro_torch.configs import get_config, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                               vocab_size=VOCAB, num_layers=layers,
                               dtype=dtype, attention_impl="xla")


def setup():
    import torch
    from repro_torch.configs import SHAPES, TrainConfig
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, VOCAB, (B, S)).astype(
        np.int64)) for k in ("tokens", "targets")}
    shape = dataclasses.replace(SHAPES[0], kind="train", seq_len=S,
                                global_batch=B)
    return batch, shape, TrainConfig(**TRAIN)


def state_of(cfg, tc):
    import torch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    p = build_model(cfg, "cpu").init(seed=0)
    return {"params": p, "opt": make_optimizer(tc).init(p),
            "step": torch.zeros((), dtype=torch.int32)}


def one_rank(layers: int, dtype: str):
    """Step 0's grads of the program on a mesh of one rank, at `dtype`
    compute, on the bf16 config's seed-0 state."""
    from repro_torch import tree as tu
    from repro_torch.configs import MeshConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import Resolver, ShardingRules
    batch, shape, tc = setup()
    mesh = tmesh.local_mesh(MeshConfig(shape=(1, 1),
                                       axis_names=("data", "model")))
    prog, _ = dryrun.build_train_program(
        config(layers, dtype), shape, mesh, Resolver(mesh, ShardingRules()),
        "baseline", tc, 1, device="cpu")
    state, grads = state_of(config(layers), tc), []
    prog(state, batch, grads_out=grads)
    return dict(tu.flatten_with_path(tu.unflatten_like(state["params"],
                                                       grads)))


def rank_main(rank: int, layers: int):
    """This rank's step-0 grads block of every run, as numpy."""
    import torch
    from repro_torch import tree as tu
    from repro_torch.configs import MeshConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import Resolver, ShardingRules
    torch.set_num_threads(1)
    batch, shape, tc = setup()
    out = {}
    for name, ms, names, flavor, micro, sp in RUNS:
        mesh = tmesh.make_process_mesh(MeshConfig(shape=ms, axis_names=names))
        res = Resolver(mesh, ShardingRules(data_axes=("data",),
                                           sequence_parallel=sp))
        prog, _ = dryrun.build_train_program(config(layers), shape, mesh, res,
                                             flavor, tc, micro, device="cpu")
        state, grads = prog.shard_state(state_of(config(layers), tc)), []
        prog(state, prog.shard_batch(batch), grads_out=grads)
        out[name] = tu.unflatten_like(state["params"],
                                      [g.numpy().copy() for g in grads])
    return out


def main(layers: int) -> None:
    import torch
    from repro_torch import bridge
    from repro_torch import tree as tu
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import Resolver, ShardingRules
    oracle, truth = one_rank(layers, "bfloat16"), one_rank(layers, "float32")

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())
    reps = tmesh.spawn(rank_main, 4, layers, threads=1, timeout_s=900)
    for name, ms, names, _, _, sp in RUNS:
        res = Resolver(dict(zip(names, ms)),
                       ShardingRules(data_axes=("data",), sequence_parallel=sp))
        whole = bridge.gather_params(
            [tu.tree_map(torch.from_numpy, r[name]) for r in reps], res,
            config(layers))
        gaps = {p: gap(t, oracle[p]) for p, t in tu.flatten_with_path(whole)}
        got = dict(tu.flatten_with_path(whole))
        worst = sorted(gaps, key=gaps.get, reverse=True)[:5]
        print(f"{name}: worst leaves against the one-rank program: " + ", ".join(
            f"{p} {gaps[p]:.3e} (to the f32 grads {gap(got[p], truth[p]):.3e}"
            f", the one-rank program's {gap(oracle[p], truth[p]):.3e})"
            for p in worst), flush=True)


if __name__ == "__main__":
    import argparse
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=os.path.join(here, "src"))
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    os.environ["PYTHONPATH"] = os.path.abspath(args.src)
    main(args.layers)
