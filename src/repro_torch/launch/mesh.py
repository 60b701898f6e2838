"""The process mesh of the `pod` and `vote` backends and of expert
parallelism (the counterpart of the reference's `launch/mesh.py::
make_test_mesh`).

The reference runs a replica per pod of a device mesh and compares inside
`shard_map`. The port runs one process per (pod, data, model) rank over
`torch.distributed`: rank r holds pod p's replica of the state on its
device, and trains on data shard d of the global batch, with r = (p * D +
d) * M + m, the reference's device order. Collectives go through gloo on
localhost, on the CPU and on the card alike: NCCL refuses two ranks on one
GPU ("Duplicate GPU detected"), and gloo takes CUDA tensors in
`all_reduce` and `broadcast`, staging them through host memory.

Groups (`dist.new_group`, made by every rank in the same order):
  * the pod group of (d, m): the ranks that hold shard d in every pod,
    ordered by pod. Replica compares, the fingerprint gather and the vote
    broadcast run over it.
  * the data group of (p, m): that pod's ranks of model index m, ordered by
    data index. The gradient average runs over it.
  * the model group of (p, d), made only when M > 1: the ranks that share
    pod and data shard, ordered by model index. Expert parallelism's
    exchanges run over it (`models/moe.py::moe_mlp_ep`); the trainers
    shard no state over it, and refuse a mesh with M > 1.

A mesh may span a subset of the ranks (`make_process_mesh(cfg, ranks)`):
the elastic trainer's survivors (`runtime/elastic.py`). Every rank makes
every group all the same, and a rank outside the subset gets None.

`spawn(fn, nprocs, *args)` starts the ranks (`torch.multiprocessing`, the
spawn method), each with its process group initialized, and returns each
rank's return value: the tests, the training launcher and `chip_smoke.py`
share it.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import MeshConfig


def axis_sizes(cfg) -> Dict[str, int]:
    """The axes of a `MeshConfig` or `ProcessMesh` larger than 1, by name:
    the shape two meshes must agree on ((2, 2, 1) over pod, data, model is
    (2, 2) over pod, data)."""
    return {n: int(s) for n, s in zip(cfg.axis_names, cfg.shape) if s != 1}


@dataclass
class ProcessMesh:
    """This rank's place in a (pod, data, model) process mesh and its
    groups."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    pod: int
    data: int
    pod_group: Any            # this rank's (data, model) index in every pod
    data_group: Any           # this rank's pod, at its model index
    pod_ranks: List[int]      # the pod group's global ranks, by pod
    ranks: List[int]          # the mesh's ranks, in (pod, data, model) order
    model: int = 0
    model_group: Any = None   # this rank's (pod, data); None when M == 1

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def n_pods(self) -> int:
        return self.sizes.get("pod", 1)

    @property
    def n_data(self) -> int:
        return self.sizes.get("data", 1)

    def pod_rank(self, pod: int) -> int:
        """Global rank of pod `pod`'s copy of this rank's data shard."""
        return self.pod_ranks[pod]


def make_process_mesh(cfg: MeshConfig,
                      ranks: Optional[Sequence[int]] = None
                      ) -> Optional[ProcessMesh]:
    """The mesh of `cfg` over `ranks` of the initialized default process
    group (default: every rank), pods x data x model of them, in (pod,
    data, model) order. Every rank of the default group must call it
    (`dist.new_group` is collective over it, even for a group the caller is
    not in); a rank outside `ranks` gets None. A rank's indices come from
    its place in `ranks`; the pod group's members (`pod_ranks`) stay global
    ranks, which `broadcast(src=)` takes."""
    shape, axis_names = tuple(cfg.shape), tuple(cfg.axis_names)
    sizes = dict(zip(axis_names, shape))
    if set(sizes) - {"pod", "data", "model"}:
        raise ValueError(f"unknown mesh axes {axis_names}")
    P, D = sizes.get("pod", 1), sizes.get("data", 1)
    M = sizes.get("model", 1)
    if not dist.is_initialized():
        raise RuntimeError("the process mesh needs an initialized process "
                           "group (launch/mesh.py::spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = P * D * M
    if ranks is None:
        ranks = list(range(world))
        if world != n:
            raise ValueError(f"mesh {shape} needs {n} ranks, the "
                             f"process group has {world}")
    ranks = [int(r) for r in ranks]
    if len(ranks) != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, given "
                         f"{len(ranks)}")
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of "
                         f"the {world}-rank process group")

    def at(p: int, d: int, m: int) -> int:
        return ranks[(p * D + d) * M + m]

    member = rank in ranks
    pod = data = model = -1
    if member:
        pd, model = divmod(ranks.index(rank), M)
        pod, data = divmod(pd, D)
    pod_group = data_group = model_group = None
    pod_ranks: List[int] = []
    for d in range(D):
        for m in range(M):
            members = [at(p, d, m) for p in range(P)]
            g = dist.new_group(members)
            if (d, m) == (data, model):
                pod_group, pod_ranks = g, members
    for p in range(P):
        for m in range(M):
            g = dist.new_group([at(p, d, m) for d in range(D)])
            if (p, m) == (pod, model):
                data_group = g
    if M > 1:
        for p in range(P):
            for d in range(D):
                g = dist.new_group([at(p, d, m) for m in range(M)])
                if (p, d) == (pod, data):
                    model_group = g
    if not member:
        return None
    return ProcessMesh(tuple(int(s) for s in shape), axis_names, rank, pod,
                       data, pod_group, data_group, pod_ranks, ranks,
                       model=model, model_group=model_group)


def local_mesh(cfg: MeshConfig) -> ProcessMesh:
    """The mesh of one rank (every axis of `cfg` of size 1) in a process
    with no process group: the sharded code on it runs no collective."""
    if any(int(n) != 1 for n in cfg.shape):
        raise ValueError(f"a local mesh has one rank, not {cfg.shape}")
    return ProcessMesh(tuple(int(n) for n in cfg.shape),
                       tuple(cfg.axis_names), 0, 0, 0, None, None, [0], [0])


def make_axes_group(mesh: ProcessMesh, axes: Sequence[str]):
    """The group over `axes` (in their order, the first slowest) of this
    rank's indices on the others: ("pod", "data") at its model index, the
    baseline flavor's data axes on a pod mesh. Collective over every rank
    of the default group, as `dist.new_group` is."""
    sizes = {a: mesh.sizes.get(a, 1) for a in ("pod", "data", "model")}
    P, D, M = sizes["pod"], sizes["data"], sizes["model"]
    mine = None
    for fixed in range(P * D * M):
        p, d, m = fixed // (D * M), fixed // M % D, fixed % M
        here = {"pod": p, "data": d, "model": m}
        if any(here[a] != 0 for a in axes):
            continue
        members = []
        for k in range(int(np.prod([sizes[a] for a in axes]))):
            c = dict(here)
            for a in reversed(axes):
                k, c[a] = divmod(k, sizes[a])
            members.append(mesh.ranks[(c["pod"] * D + c["data"]) * M
                                      + c["model"]])
        g = dist.new_group(members)
        if mesh.rank in members:
            mine = g
    return mine


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn: Callable, world: int, port: int, results,
           args: tuple, threads: int, timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results.put((rank, fn(rank, *args)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, threads: int = 0,
          timeout_s: float = 600.0) -> List[Any]:
    """Run `fn(rank, *args)` in `nprocs` spawned processes, each with a gloo
    process group on localhost, and return their results by rank. `fn` and
    `args` must pickle (a module-level function). `threads` > 0 sets each
    rank's torch threads. A rank that raises, or a run longer than
    `timeout_s`, kills every rank and raises here. The ranks inherit the
    environment, with the cuBLAS workspace that deterministic replicas on
    the card need set first, and gloo held to the loopback interface."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = mp.start_processes(
        _entry, args=(fn, nprocs, port, results, args, threads, timeout_s),
        nprocs=nprocs, join=False, start_method="spawn")
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < nprocs:
            try:
                rank, value = results.get(timeout=1.0)
                out[rank] = value
                continue
            except queue.Empty:
                pass
            if procs.join(timeout=0) and len(out) < nprocs:
                # every rank exited: read what was left in the queue
                while not results.empty():
                    rank, value = results.get()
                    out[rank] = value
                missing = sorted(set(range(nprocs)) - set(out))
                if missing:
                    raise RuntimeError(f"ranks {missing} exited without a "
                                       "result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{timeout_s} s")
        while not procs.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
        for p in procs.processes:
            p.join()
    return [out[r] for r in range(nprocs)]

