"""SEDAR-protected training (the reference's `runtime/train.py`), a thin
layer over the engine for the single-card backends `none`, `sequential`,
`fused`, `abft` and `hybrid` and the mesh backends `pod` and `vote`.

Everything about the protocol (replica compare, TDC commit gate, FSC
validation, TOE watchdog, the L1/L2/L3 checkpoint boundaries and recovery)
is in `core/engine.py`; this module supplies the training pieces:

  * the replica step: loss and grads (autograd) -> [inject] -> the grads'
    fingerprint (K1, one launch over every gradient leaf in place, with
    `fused_fingerprint`) -> the optimizer's out-of-place step
    (`Optimizer.apply`, which frees each gradient leaf as it goes) ->
    [inject];
  * the fused step (`fused`): both replicas' states stacked on a leading
    axis of 2 and stepped together — the forward through `torch.vmap` over
    the stacked params with autograd's backward through it (each replica
    on its own for `PER_REPLICA_FAMILIES`), the optimizer
    over the stacked leaves with each replica's own global norm and
    schedule (`apply(replicas=True)`, what a `torch.vmap` of the update
    computes); K1 (a ctypes kernel,
    which vmap cannot enter) runs outside, one launch per replica's view of
    the stacked grads; a fault lands on replica 1's slice;
  * the single-instance step of `abft`/`hybrid`: the same replica step
    with no grads fingerprint (there is no replica to compare it with) and
    no checksummed product, as in the reference, whose training step is
    uninstrumented: abft detects nothing in training, hybrid adds the
    resident-state fingerprint check (`abft/executor.py`);
  * the state fingerprints: per leaf (`state_fp`: reports, L2 manifests, L3
    validation) and whole-state (`state_fp_fast`: the FSC compare and
    hybrid's commit and entry fingerprints), both through K1 on the card;
  * the mesh step of `pod`/`vote` (`mesh=`, a `launch/mesh.py::
    ProcessMesh`; one trainer per rank; `none` takes a mesh too, its
    grads averaged over the data group: the elastic trainer's survivors
    of a lost replica pod): the rank's rows of the global
    batch -> loss and grads, averaged over the pod's data group -> [the
    grads fault, on pod `spec.replica`'s ranks] -> pod: the grads' lanes
    (one per data shard, K1 in one launch) and the lane compare over the
    pod group; vote: the whole-state fingerprint and its gather -> the
    optimizer -> [the params fault] -> the commit gated on the compare,
    leaf by leaf into the candidate's own tensors. `pod_validate` compares
    {params, opt} the same way. Each rank keeps its checkpoints under
    `workdir/rank{r}`; every rank decides alike (its reads come out of
    collectives), so every rank restores the same version;
  * the outer loop: the step counter tracked on the host (a recovery
    re-reads it once), per-step losses kept on the device and drained in
    batches, `truncate_to` keeping the loss record on the delivered
    trajectory across rollbacks, the final validation and the durability
    barrier (every disk-backed checkpoint tier).

The engine's "batch" is the pair (host step, batch): injection decides on
the host from the step, as the port's injection does everywhere. Runs on
the card unless `device="cpu"` is given.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.configs.base import RunConfig
from repro_torch.core import hostsync
from repro_torch.core.detection import (DetectionEvent, SedarSafeStop,
                                        Watchdog, lanes_equal,
                                        make_lane_comparator,
                                        make_pod_broadcaster,
                                        make_pod_comparator,
                                        make_pod_injector)
from repro_torch.core.engine import replica_view
from repro_torch.core.fingerprint import (leaf_fingerprints,
                                          pytree_fingerprint_fused,
                                          pytree_fingerprint_lanes)
from repro_torch.core.injection import InjectionFlag, InjectionSpec, inject_tree
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import make_recovery
from repro_torch.data import make_pipeline
from repro_torch.device import make_deterministic, resolve_device, upload
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer

# Families whose fused backend runs each replica's loss and backward on its
# own (the optimizer and K1 still take the stacked leaves): on the card the
# xLSTM's loss under `torch.vmap` drifted 2.0e-3 (relative) from the
# sequential backend's in 4 adamw steps on an NVIDIA H100 80GB HBM3, 13x
# the fused gate that the other five families meet (PERF.md §6).
PER_REPLICA_FAMILIES = ("ssm",)

MESH_BACKENDS = ("pod", "vote")


@dataclass
class TrainReport:
    steps_completed: int = 0
    losses: List[float] = field(default_factory=list)
    detections: List[DetectionEvent] = field(default_factory=list)
    recoveries: List[Dict[str, Any]] = field(default_factory=list)
    checkpoints: List[int] = field(default_factory=list)
    stopped: bool = False
    wall_s: float = 0.0
    # replica 0's per-leaf fingerprint of {params, opt} at the end, as the
    # reference's uint32 (n_leaves, 4) array
    final_state_fp: Optional[np.ndarray] = None
    restored_from: List[str] = field(default_factory=list)

    def summary(self) -> str:
        tiers = f" restored_from={self.restored_from}" \
            if self.restored_from else ""
        return (f"steps={self.steps_completed} detections={len(self.detections)} "
                f"recoveries={len(self.recoveries)} ckpts={len(self.checkpoints)} "
                f"stopped={self.stopped} wall={self.wall_s:.1f}s "
                f"loss={self.losses[-1] if self.losses else float('nan'):.4f}"
                f"{tiers}")


class SedarTrainer:
    """Drives SEDAR-protected training of any family the port runs (dense,
    moe, hybrid, vlm, ssm, audio)."""

    def __init__(self, run_cfg: RunConfig, workdir: str,
                 inj_spec: Optional[InjectionSpec] = None,
                 toe_delay: Optional[Dict[Any, float]] = None,
                 data=None, notify: Optional[Callable] = None,
                 device=None, autotune=None, mesh=None,
                 hosts_per_data_shard: int = 1):
        self.cfg = run_cfg
        # closed-loop knob tuning: a `core/policy.py::Autotuner` whose
        # maybe_tune() ticks after every protected step
        self.autotune = autotune
        self.backend = run_cfg.sedar.replication
        if self.backend == "dual":          # the reference's alias
            self.backend = "sequential"
        self.mesh = mesh
        if self.backend in MESH_BACKENDS and mesh is None:
            raise ValueError(
                f"{self.backend!r} training needs mesh= (a "
                "launch/mesh.py::ProcessMesh, one trainer per rank)")
        if mesh is not None and self.backend not in MESH_BACKENDS + ("none",):
            raise ValueError(
                f"{self.backend!r} runs on one card: a process mesh takes "
                f"{MESH_BACKENDS} or 'none' (the elastic trainer's "
                "survivors of a lost replica pod)")
        # the mesh's shape comes from run_cfg.mesh alone; `mesh` supplies
        # this rank's indices and the process groups
        sizes = axis_sizes(run_cfg.mesh)
        self.n_pods, self.n_data = sizes.get("pod", 1), sizes.get("data", 1)
        if mesh is not None:
            if axis_sizes(mesh) != sizes:
                raise ValueError(
                    f"the process mesh {axis_sizes(mesh)} disagrees with "
                    f"run_cfg.mesh {sizes}")
            if sizes.get("model", 1) > 1:
                raise NotImplementedError(
                    "the trainer shards no state over a model axis (expert "
                    "parallelism runs in models/moe.py::moe_mlp_ep)")
            if run_cfg.train.global_batch % self.n_data:
                raise ValueError(
                    f"global batch {run_cfg.train.global_batch} does not "
                    f"split over {self.n_data} data shards")
            # ranks must not write the same files
            workdir = os.path.join(workdir, f"rank{mesh.rank}")
        self.workdir = workdir
        self.hosts_per_data_shard = max(int(hosts_per_data_shard), 1)
        self.device = resolve_device(device)
        make_deterministic(self.device)
        os.makedirs(workdir, exist_ok=True)
        self.model = build_model(run_cfg.model, self.device)
        self.opt = make_optimizer(run_cfg.train)
        self.inj_spec = inj_spec
        self.inj_flag = InjectionFlag(os.path.join(workdir, "injected.json"))
        self.toe_delay = toe_delay or {}
        self.data = data or make_pipeline(run_cfg.model,
                                          run_cfg.train.global_batch,
                                          run_cfg.train.seq_len,
                                          run_cfg.train.seed)
        self.sedar = dataclasses.replace(
            run_cfg.sedar, checkpoint_dir=os.path.join(workdir, "ckpt"))
        self.recovery = make_recovery(self.sedar, workdir)
        self.watchdog = Watchdog(self.sedar.toe_timeout_s)
        self.notify = notify or (lambda e: print(str(e), flush=True))
        fused = self.backend == "fused"
        pod_kw = self._mesh_fns() if self.backend in MESH_BACKENDS else {}
        self.engine = make_engine(
            self.sedar, backend=self.backend,
            step_fn=self._fused_step if fused else self._replica_step,
            state_fp_fn=self._state_fp,
            fast_state_fp_fn=self._state_fp_fast,
            recovery=self.recovery, watchdog=self.watchdog,
            inj_spec=inj_spec, inj_flag=self.inj_flag,
            init_fn=self.init_dual, notify=self.notify,
            delay_source=lambda: self.toe_delay,
            stack="leading" if fused else "rows", **pod_kw)

    # -- state ----------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None):
        params = self.model.init(self.cfg.train.seed if seed is None
                                 else seed)
        return {"params": params, "opt": self.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def init_dual(self, seed: Optional[int] = None):
        return self.engine.executor.init_dual(self.init_state(seed))

    # -- the replica step and the fingerprints ---------------------------------

    def _grad_fp(self, grads):
        if self.sedar.fused_fingerprint:
            return pytree_fingerprint_fused(grads)
        return leaf_fingerprints(grads)

    def loss_and_grads(self, params, batch):
        """(loss, grads) of the model's loss at `params`: autograd through
        detached copies of the leaves, so the grads are new tensors and
        `params` is left as it was. Every gradient is made contiguous (the
        tied embedding's arrives transposed from the head's product), so K1
        reads the whole tree in place in one launch."""
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_util.leaves(params)]
        with torch.enable_grad():
            loss = self.model.loss(tree_util.unflatten_like(params, leaves),
                                   batch)[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), tree_util.unflatten_like(params, [
            torch.zeros_like(p) if g is None else g.contiguous()
            for g, p in zip(grads, leaves)])

    def loss_and_grads_stacked(self, params, batch):
        """`loss_and_grads` of both replicas at once: `params` stacks them
        on a leading axis of 2. The forward is one `torch.vmap` over the
        stacked leaves; autograd's backward of the summed losses gives each
        replica its own gradient (d sum / d loss_r = 1 exactly). A family
        in `PER_REPLICA_FAMILIES` runs each replica's `loss_and_grads` on
        its view instead, its grads written into the stacked leaves.
        Returns (losses (2,), stacked grads, each contiguous)."""
        if self.cfg.model.family in PER_REPLICA_FAMILIES:
            losses, stacked = [], None
            for r in range(2):
                loss, grads = self.loss_and_grads(replica_view(params, r),
                                                  batch)
                flat = tree_util.leaves(grads)
                del grads
                if stacked is None:
                    stacked = [g.new_empty((2,) + tuple(g.shape))
                               for g in flat]
                for buf, g in zip(stacked, flat):
                    buf[r].copy_(g)
                del flat
                losses.append(loss)
            return torch.stack(losses), tree_util.unflatten_like(params,
                                                                 stacked)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_util.leaves(params)]
        with torch.enable_grad():
            losses = torch.vmap(lambda p: self.model.loss(p, batch)[0])(
                tree_util.unflatten_like(params, leaves))
            grads = torch.autograd.grad(losses.sum(), leaves,
                                        allow_unused=True)
        return losses.detach(), tree_util.unflatten_like(params, [
            torch.zeros_like(p) if g is None else g.contiguous()
            for g, p in zip(grads, leaves)])

    def _inject_stacked(self, tree, target: str, step: int, armed):
        """The fault of a fused step: `inject_tree` decides per replica on
        that replica's view, and a flip it makes is written into that
        replica's slice of the stacked leaf (a fresh tensor of this step)."""
        spec = self.inj_spec
        if spec is None or spec.target != target:
            return tree
        for r in range(2):
            view = replica_view(tree, r)
            hit = inject_tree(view, spec, step=step, replica_id=r,
                              armed=armed)
            if hit is not view:
                leaf = tree_util.leaves(tree)[spec.leaf_idx]
                leaf[r].copy_(tree_util.leaves(hit)[spec.leaf_idx])
        return tree

    def _fused_step(self, stacked, step_batch, armed):
        """(stacked state, (host step, batch), armed) -> (candidate, grads
        fingerprints (2, 4), replica 0's loss): both replicas in one set of
        launches, K1 once per replica's grads view (a contiguous slice of
        each stacked leaf, read in place)."""
        step, batch = step_batch
        params = stacked["params"]
        losses, grads = self.loss_and_grads_stacked(params, batch)
        grads = self._inject_stacked(grads, "grads", step, armed)
        fps = torch.stack([self._grad_fp(replica_view(grads, r))
                           for r in range(2)])
        # the optimizer drops each stacked gradient leaf once it is stepped
        g = tree_util.leaves(grads)
        del grads
        new_params, new_opt = self.opt.apply(
            g, stacked["opt"], params, stacked["step"], replicas=True)
        new_params = self._inject_stacked(new_params, "params", step, armed)
        new_opt = self._inject_stacked(new_opt, "opt_state", step, armed)
        cand = {"params": new_params, "opt": new_opt,
                "step": stacked["step"] + 1}
        return cand, fps, losses[0]

    def batch(self, step: int):
        """The batch of `step` on the trainer's device: integer leaves
        (tokens, targets) as int64, float leaves (a frontend's stub
        embeddings) at their own dtype and values. A mesh rank takes its
        data shard's rows of the global batch."""
        out = {}
        for k, v in self.data.batch(step).items():
            v = np.asarray(v)
            if self.mesh is not None:
                rows = v.shape[0] // self.n_data
                v = v[self.mesh.data * rows:(self.mesh.data + 1) * rows]
            if np.issubdtype(v.dtype, np.integer):
                v = v.astype(np.int64)
            out[k] = upload(v, self.device)
        return out

    # -- the mesh step (pod, vote) ----------------------------------------------

    def _mesh_fns(self) -> Dict[str, Any]:
        """The pod step, its validation and (vote) the broadcaster, for
        `make_engine`."""
        mesh, spec = self.mesh, self.inj_spec
        self._pod_cmp = make_pod_comparator(mesh)
        self._pod_inject = (make_pod_injector(mesh, spec)
                            if spec is not None else None)
        # pod: one fingerprint lane per data shard, compared by reductions
        # (a divergence localizes to a shard and its hosts); vote: the
        # whole-state fingerprint and its gather, which the vote consumes
        self._n_lanes = self.n_data if self.backend == "pod" else 0
        kw: Dict[str, Any] = dict(
            pod_step=self._pod_step, pod_validate=self._pod_validate,
            n_replicas=self.n_pods)
        if self._n_lanes:
            from repro_torch.runtime.cluster import lanes_to_hosts
            self._lane_cmp = make_lane_comparator(mesh)
            hpds = self.hosts_per_data_shard
            kw["lane_hosts"] = lambda lanes: lanes_to_hosts(
                lanes, hosts_per_data_shard=hpds)
        if self.backend == "vote":
            kw["pod_broadcaster"] = make_pod_broadcaster(mesh)
        return kw

    def _data_mean(self, loss, grads):
        """The global batch's loss and grads from this rank's shard: the
        mean of the data group's shard means (equal shards), every grads
        leaf summed in place over the group and scaled by 1 / D."""
        D = self.n_data
        if D == 1:
            return loss, grads
        group = self.mesh.data_group
        for g in tree_util.leaves(grads):
            with hostsync.collective("grad_allreduce"):
                dist.all_reduce(g, group=group)
            g.div_(D)
        loss = loss.clone()
        with hostsync.collective("grad_allreduce"):
            dist.all_reduce(loss, group=group)
        return loss / D, grads

    def _pod_inject_tree(self, tree, target: str, step: int, armed):
        if self._pod_inject is None or self.inj_spec.target != target:
            return tree
        return self._pod_inject(tree, step, armed)

    def _pod_step(self, state, step_batch, armed):
        """(state, (host step, batch shard), armed) -> (new state, eq,
        fp_all or None, loss): the compare, then the commit gated on it."""
        step, batch = step_batch
        params = state["params"]
        loss, grads = self._data_mean(*self.loss_and_grads(params, batch))
        grads = self._pod_inject_tree(grads, "grads", step, armed)
        if self._n_lanes:
            eq = self._lane_cmp(pytree_fingerprint_lanes(grads,
                                                         self._n_lanes))
            ok, fp_all = torch.all(eq), None
        else:
            eq, fp_all = self._pod_cmp(self._grad_fp(grads))
            ok = eq
        # the optimizer drops each gradient leaf once it is stepped
        g = tree_util.leaves(grads)
        del grads
        new_params, new_opt = self.opt.apply(g, state["opt"], params,
                                             state["step"])
        new_params = self._pod_inject_tree(new_params, "params", step, armed)
        cand = {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}
        # where(ok, candidate, state) into the candidate's own (fresh)
        # tensors: no second state lives beside the two
        tree_util.tree_map(
            lambda c, p: torch.where(ok, c, p, out=c)
            if isinstance(c, torch.Tensor) else c, cand, state)
        return cand, eq, fp_all, loss

    def _pod_validate(self, state):
        """(eq, fp_all) of {params, opt} over the pod group: per-lane eq
        from the gathered lanes (pod), or the whole-state compare (vote)."""
        if self._n_lanes:
            _, fp_all = self._pod_cmp(pytree_fingerprint_lanes(
                {"params": state["params"], "opt": state["opt"]},
                self._n_lanes))
            return lanes_equal(fp_all), fp_all
        return self._pod_cmp(self._state_fp_fast(state))

    def _replica_step(self, state, step_batch, replica_id: int, armed: bool):
        """(state, (host step, batch), replica, armed) -> (candidate, grads
        fingerprint, loss). New tensors throughout: the pre-step state
        stays as it was."""
        step, batch = step_batch
        spec = self.inj_spec
        params = state["params"]
        loss, grads = self.loss_and_grads(params, batch)
        if self.mesh is not None:       # `none` over a data group
            loss, grads = self._data_mean(loss, grads)
        if spec is not None and spec.target == "grads":
            grads = inject_tree(grads, spec, step=step,
                                replica_id=replica_id, armed=armed)
        # abft/hybrid have no second replica to compare the grads with
        fp = self._grad_fp(grads) if self.backend != "abft" and \
            self.backend != "hybrid" else None
        # the optimizer drops each gradient leaf once it is stepped
        g = tree_util.leaves(grads)
        del grads
        new_params, new_opt = self.opt.apply(g, state["opt"], params,
                                             state["step"])
        if spec is not None and spec.target == "params":
            new_params = inject_tree(new_params, spec, step=step,
                                     replica_id=replica_id, armed=armed)
        if spec is not None and spec.target == "opt_state":
            new_opt = inject_tree(new_opt, spec, step=step,
                                  replica_id=replica_id, armed=armed)
        cand = {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}
        return cand, fp, loss

    @staticmethod
    def _state_fp(state):
        """Per-leaf (n_leaves, 4) of {params, opt} (K1 per leaf on the
        card): reports, L2 manifests and the L3 checkpoint's fingerprint."""
        return leaf_fingerprints({"params": state["params"],
                                  "opt": state["opt"]})

    def _state_fp_fast(self, state):
        """The FSC compare: one K1 launch over {params, opt} in place."""
        tree = {"params": state["params"], "opt": state["opt"]}
        if self.sedar.fused_fingerprint:
            return pytree_fingerprint_fused(tree)
        return leaf_fingerprints(tree)

    # -- outer loop -----------------------------------------------------------

    def _host_step(self, dual) -> int:
        """ONE read of the device step counter: at the start and after a
        recovery, never in the fault-free loop."""
        return hostsync.read_int(self.engine.executor.peek(dual, "step"),
                                 label="step_counter")

    def run(self, num_steps: int, dual=None,
            max_wall_steps: Optional[int] = None):
        """The outer loop -> (dual, TrainReport). The host tracks the step
        (a committed outcome advances it; a recovery re-reads it once), the
        per-step losses stay on the device and drain in one batched read at
        the end (or every 4096 steps at a flushed boundary): a fault-free
        protected step at lag D > 1 reads nothing from the device."""
        rep = TrainReport()
        t0 = time.time()
        eng = self.engine
        eng.reset()
        dual = dual if dual is not None else self.init_dual()
        budget = max_wall_steps or (6 * num_steps + 60)
        executed = 0
        step = self._host_step(dual)
        step0 = step
        # invariant: len(drained) + len(aux_buf) == step - step0, so a
        # rollback can truncate the record to the delivered trajectory
        drained: List[float] = []
        aux_buf: List[Any] = []

        def drain():
            drained.extend(float(a) for a in
                           hostsync.batched_get(aux_buf, label="loss_drain"))
            aux_buf.clear()

        def truncate_to(n_keep: int):
            if n_keep <= len(drained):
                del drained[n_keep:]
                aux_buf.clear()
            else:
                del aux_buf[n_keep - len(drained):]

        def recover(event) -> bool:
            """on_detection; False after a safe stop."""
            nonlocal dual, step
            try:
                dual = eng.on_detection(event, dual)
            except SedarSafeStop:
                rep.stopped = True
                return False
            step = self._host_step(dual)
            truncate_to(step - step0)
            return True

        while True:
            if step >= num_steps:
                # an optimistic commit in the last D steps may still fail
                event = eng.flush_deferred()
                if event is None or not recover(event):
                    break
                continue
            if executed >= budget:
                rep.stopped = True
                break
            executed += 1
            with obs.span("train_step", step=step):
                outcome = eng.run_protected_step(
                    dual, (step, self.batch(step)), step)
            # unpacked and dropped: the outcome must not keep a state alive
            # through a recovery and the next step
            dual, aux, event = outcome.dual, outcome.aux, outcome.event
            committed = outcome.committed
            del outcome
            # aux is None when the executor refused the step before running
            # it (hybrid's entry check): there is no loss to record
            if committed and aux is not None:
                aux_buf.append(aux)
                step += 1
            if event is not None:
                if not recover(event):
                    break
            elif len(aux_buf) >= 4096 and not eng.pending_validation:
                drain()
            if self.autotune is not None:
                # host-side only (registry and journal reads); a lag change
                # lands through apply_reconfig, at a clean flush boundary
                self.autotune.maybe_tune(eng, step)

        # final validation (paper: final results comparison)
        if not rep.stopped:
            event = eng.validate_final(dual, step)
            if event is not None:
                try:
                    dual = eng.on_detection(event, dual)
                except SedarSafeStop:
                    rep.stopped = True
        drain()
        rep.losses = drained
        rep.detections = list(eng.detections)
        rep.recoveries = list(eng.recoveries)
        rep.checkpoints = list(eng.checkpoints)
        rep.steps_completed = self._host_step(dual)
        rep.restored_from = [r["tier"] for r in rep.recoveries
                             if r.get("tier")]
        rep.final_state_fp = np.asarray(hostsync.read_scalar(
            self._state_fp(eng.executor.primary(dual)),
            label="final_fp")).view(np.uint32)
        # durability barrier: the async writers are daemon threads; without
        # it a process exit can strand .tmp staging dirs (tiered configs:
        # every disk-backed tier, the partner store too)
        tiers = getattr(self.recovery, "tiers", None)
        store = tiers if tiers is not None else \
            getattr(self.recovery, "store", None)
        if store is not None:
            store.wait()
        rep.wall_s = time.time() - t0
        return dual, rep
