"""Decoder LM (the reference's `models/transformer.py`): init, full-sequence
trunk, training loss, prefill and decode for the dense, moe, vlm, hybrid
and ssm families.

  dense / moe / vlm : a homogeneous layer stack, params["layers"] stacked
                      over L; moe swaps the MLP for `moe.moe_mlp`; vlm puts
                      the frontend's embeddings in front of the tokens.
  hybrid (griffin)  : pattern groups (rec, rec, attn) stacked over G in
                      params["groups"], the rest in params["tail"], blocks
                      named b{i}_{kind}; the attention blocks are local
                      (cfg.window_size) with ring-buffer decode caches.
  ssm (xlstm)       : pattern groups (mlstm, slstm), the same way; their
                      decode states are recurrent (models/xlstm.py).

The reference scans over stacked params with `lax.scan`; here a Python
loop walks the layers (groups) and slices each stacked leaf (a view, no
copy). Params keep the reference's tree, so a leaf index and a fingerprint
mean the same leaf in both packages. The audio family (enc-dec) is
`models/encdec.py`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import bridge
from repro_torch import sharding as shd
from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.remat import remat
from repro_torch.models import xlstm as xlstm_lib

PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
PORTED_BLOCKS = ("attention", "recurrent", "mlstm", "slstm")


def check_family(cfg) -> None:
    """Raise NotImplementedError for a family or block kind the port does
    not know (the reference knows no other)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"unknown model family {cfg.family!r} "
                                  f"(ported: {PORTED_FAMILIES})")
    for kind in cfg.block_pattern:
        if kind not in PORTED_BLOCKS:
            raise NotImplementedError(f"unknown block kind {kind!r} "
                                      f"(ported: {PORTED_BLOCKS})")


def _is_moe(cfg) -> bool:
    return cfg.family == "moe" and cfg.num_experts > 0


def pattern_tail(cfg) -> Tuple[str, ...]:
    pat = tuple(cfg.block_pattern)
    return pat[: cfg.num_layers - (cfg.num_layers // len(pat)) * len(pat)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_dense_layer_stack(gen, cfg, L: int, device):
    pdt = nn.torch_dtype(cfg.param_dtype)
    mlp = (moe_lib.init_moe(gen, cfg, L, device) if _is_moe(cfg)
           else nn.init_mlp(gen, cfg, L, device))
    return {"attn": nn.init_attention(gen, cfg, L, device),
            "mlp": mlp,
            "ln1": torch.zeros((L, cfg.d_model), dtype=pdt, device=device),
            "ln2": torch.zeros((L, cfg.d_model), dtype=pdt, device=device)}


def _init_group_stack(gen, cfg, pattern, G: int, device):
    """One stacked group of blocks following `pattern`."""
    pdt = nn.torch_dtype(cfg.param_dtype)
    init_core = {"attention": nn.init_attention,
                 "recurrent": rec_lib.init_recurrent_block,
                 "mlstm": xlstm_lib.init_mlstm_block,
                 "slstm": xlstm_lib.init_slstm_block}
    p = {}
    for i, kind in enumerate(pattern):
        entry = {"core": init_core[kind](gen, cfg, G, device),
                 "ln": torch.zeros((G, cfg.d_model), dtype=pdt, device=device)}
        # the xLSTM blocks carry their own projections
        if kind in ("attention", "recurrent") and cfg.d_ff:
            entry["mlp"] = nn.init_mlp(gen, cfg, G, device)
            entry["ln2"] = torch.zeros((G, cfg.d_model), dtype=pdt,
                                       device=device)
        p[f"b{i}_{kind}"] = entry
    return p


def init_lm(gen: torch.Generator, cfg, device) -> Dict[str, Any]:
    """Seeded random params (f32 masters) on `device`."""
    check_family(cfg)
    pdt = nn.torch_dtype(cfg.param_dtype)
    params = {"embed": nn.init_embedding(gen, cfg, device),
              "final_ln": torch.zeros((cfg.d_model,), dtype=pdt,
                                      device=device)}
    if cfg.block_pattern:
        pat = tuple(cfg.block_pattern)
        params["groups"] = _init_group_stack(
            gen, cfg, pat, cfg.num_layers // len(pat), device)
        tail = pattern_tail(cfg)
        if tail:
            params["tail"] = _init_group_stack(gen, cfg, tail, 1, device)
    else:
        params["layers"] = _init_dense_layer_stack(gen, cfg, cfg.num_layers,
                                                   device)
    return params


def _slice(tree, i: int):
    """Layer (group) i's slice of a stacked tree (views)."""
    return tree_util.tree_map(lambda a: a[i], tree)


def _stack(trees):
    """Per-group trees of one structure -> one tree stacked over groups."""
    return tree_util.tree_map(lambda *xs: torch.stack(xs), *trees)


def layer_params(params, i: int):
    """Layer i's slice of the stacked layer params (views)."""
    return _slice(params["layers"], i)


def _stages(cfg, tree):
    """(name, pattern, stacked tree, depth) of the groups, then of the tail
    if any; `tree` is the params or a cache."""
    out = [("groups", tuple(cfg.block_pattern))]
    if "tail" in tree:
        out.append(("tail", pattern_tail(cfg)))
    return [(name, pat, tree[name],
             tree_util.leaves(tree[name])[0].shape[0]) for name, pat in out]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardCtx:
    """A rank's place on a process mesh for the layers that shard (the
    reference's `ShardCtx`): its `launch/mesh.py::ProcessMesh` and a
    `sharding.Resolver` over it, the one object that says where each
    activation and parameter lives.

    Without `specs` only the MoE blocks shard: every other param is whole
    on the rank, and `moe.moe_mlp_ep` runs the experts over the model
    group (the experts cut by `bridge.expert_shard`). With `specs` (the
    params' partition entries, `bridge.partition`) and `dtype` (the
    layers' compute dtype) every layer of a dense or moe model runs on
    the rank's blocks (`bridge.shard_params`):

      * FSDP: a leaf sharded over the data axes is gathered (it moves as
        stored: bf16 for the reference's `_half_params`) when a layer
        reaches it, and its gradient reduce-scattered (`params`);
      * tensor parallelism over the model axis: attention by heads (k/v
        by kv heads where KV divides, else each rank takes the kv heads
        its q heads read), or, where the heads do not divide, the rows of
        the batch over the model ranks with every weight whole (the
        reference's `batch_dm`); the MLP column- then row-parallel; the
        embedding, head and CE split over the vocab;
      * sequence parallelism (`rules.sequence_parallel`): the residual
        stream split over the model axis along the sequence.

    `decode` (a serving decode step, `lm_decode_step`): no sequence
    parallelism, and attention laid out as the KV cache is
    (`cache_split`): by kv heads where they split, else by blocks of the
    head dim, whose q/k/v products each rank takes on its stored blocks.

    `act` places the collectives at the reference's hint points, where the
    reference constrains GSPMD (`sharding.py`'s Functions). On a mesh of
    more than one rank the products whose outputs or grads a collective
    sums take f32 carriers of the compute dtype's values (`acc`): the
    weights as `params` lays them out, the activations as `act` brings
    them to the column products; every product is rounded to the compute
    dtype where the unsharded layer rounds it (`layers.qkv_project`), a
    row-parallel product after the f32 sum of its partials, so a sum over
    ranks rounds once, as one product over the whole contraction does.
    On a mesh of one rank the layers run the unsharded code. `data_group`
    is the group of the rules' data axes when they are not the mesh's
    data axis alone (("pod", "data"), the baseline flavor on a pod mesh).
    """

    mesh: Any
    resolver: Any
    specs: Any = None
    data_group: Any = None
    dtype: Any = None
    decode: bool = False

    def tp_size(self) -> int:
        r = self.resolver.rules
        return r.axis_size(self.mesh, r.model_axes)

    # -- the layout ---------------------------------------------------------

    @property
    def sharded(self) -> bool:
        return self.specs is not None

    @property
    def sp(self) -> bool:
        """Sequence parallelism on: the residual stream split over the
        model axis along the sequence."""
        return (self.sharded and self.resolver.rules.sequence_parallel
                and self.tp_size() > 1 and not self.decode)

    @property
    def acc(self):
        """The carriers' dtype (f32) on a sharded mesh of more than one
        rank; None where the layers run the unsharded code."""
        if not self.sharded or (self.tp_size() == 1
                                and self.data_axis.size == 1):
            return None
        return torch.float32

    @property
    def rounds(self):
        """The dtype the layers round their products to (the compute
        dtype) where they take carriers, else None."""
        return None if self.acc is None else self.dtype

    @property
    def model_axis(self):
        return shd.Axis(getattr(self.mesh, "model_group", None),
                        self.tp_size(), getattr(self.mesh, "model", 0), "tp")

    @property
    def data_axis(self):
        r, m = self.resolver.rules, self.mesh
        idx, n = bridge.block_index(tuple(r.data_axes), bridge.mesh_coords(m),
                                    bridge.mesh_sizes(self.resolver))
        group = self.data_group if self.data_group is not None \
            else m.data_group
        return shd.Axis(group, n, idx, "fsdp")

    def batch_dm(self, cfg) -> bool:
        """The heads do not split over the model ranks: attention takes
        the reference's `batch_dm` layout."""
        return (self.sharded and self.tp_size() > 1
                and cfg.num_heads % self.tp_size() != 0)

    def vocab_parallel(self, cfg) -> bool:
        """The embedding, head and CE split over the model ranks' vocab."""
        return (self.sharded and self.tp_size() > 1
                and cfg.vocab_size % self.tp_size() == 0)

    def expert_parallel(self, cfg, tokens: int) -> bool:
        """The reference's condition for expert parallelism
        (`models/moe.py:167-179`): the experts split over the model ranks
        and `tokens`, a data shard's (its global count over data x
        model), over the token shards; otherwise each data shard routes
        as its own dispatch group."""
        tp = self.tp_size()
        return tp > 1 and cfg.num_experts % tp == 0 and tokens % tp == 0

    def cache_split(self, cfg) -> Optional[str]:
        """The KV cache's dim that the model ranks split (the resolver's
        rule on ("layers", "batch", None, "kv_heads", "head_dim")):
        "kv_heads" where they divide, else "head_dim" where it divides,
        else None (whole on every rank)."""
        tp = self.tp_size()
        if tp == 1:
            return None
        if cfg.num_kv_heads % tp == 0:
            return "kv_heads"
        return "head_dim" if cfg.head_dim % tp == 0 else None

    @staticmethod
    def _entry(axes):
        return axes[0] if len(axes) == 1 else tuple(axes)

    def act(self, x, *logical):
        """The reference's activation hints as collectives over the model
        axis (the identity where the layers run the unsharded code):

          * ("batch", None, None), before the column-parallel products: x
            in the residual layout -> the whole sequence on every rank, as
            a carrier (SP: the all-gather along the sequence, whose
            backward reduce-scatters; else the copy whose backward sums
            the ranks' partial grads);
          * ("batch", "seq", None), after the row-parallel products: x a
            partial sum over the ranks -> the residual layout, rounded to
            the compute dtype after the sum (SP: the reduce-scatter along
            the sequence; else the sum);
          * ("batch_dm", None, None) and ("batch_dm", "seq", None), around
            attention whose heads do not split: the rank's rows of the
            whole sequence, and back from them (the rows gathered; SP:
            the rank's part of the sequence kept)."""
        acc = self.acc
        if acc is None:
            return x
        axis, tp = self.model_axis, self.tp_size()
        if logical[1:] == (None, None):
            if tp == 1:
                x = x.to(acc)
            elif self.sp:
                x = shd.gather(x, 1, axis, dtype=acc)
            else:
                x = shd.copy_to(x.to(acc), axis)
            if logical[0] == "batch_dm":
                n = x.shape[0] // tp
                if x.shape[0] % tp:
                    raise NotImplementedError(
                        f"the heads do not split over {tp} model ranks and "
                        f"{x.shape[0]} rows do not either")
                x = x.narrow(0, axis.index * n, n)
            return x
        if logical[1:] != ("seq", None):
            raise ValueError(f"no collective for the hint {logical}")
        if logical[0] == "batch_dm":
            x = x.to(self.dtype)
            if not self.sp:
                return shd.gather(x, 0, axis, "slice")
            n = x.shape[1] // tp
            return shd.gather(x, 0, axis).narrow(1, axis.index * n, n)
        if tp == 1:
            return x.to(self.dtype)
        if self.sp:
            return shd.scatter(x, 1, axis, self.dtype)
        return shd.reduce_from(x, axis, self.dtype)

    def whole_seq(self, x):
        """x in the residual layout -> the whole sequence, every rank
        using it alike (SP: the all-gather, whose backward takes the
        rank's own block)."""
        return shd.gather(x, 1, self.model_axis, "slice") if self.sp else x

    def own_seq(self, x):
        """x whole on every rank -> the residual layout (SP: the rank's
        part of the sequence)."""
        return shd.split(x, 1, self.model_axis) if self.sp else x

    def param(self, w, spec, plan, dtype, rounds: bool = True):
        """This rank's param block `w` (stored as `spec` places it) in the
        layout its layer computes in, cast to `dtype` where a collective
        touches it: every sum of its partial grads runs in that dtype
        before the cast back to w's. Over the data axes: the data-sharded
        dims gathered (w's bytes move; backward: the reduce-scatter); a
        leaf with none, copied (backward: its grads summed over the data
        ranks). Then over the model axis by `plan`: an int, the dim of
        which the rank takes its block; "own", the block it stores
        (whole where the leaf is not model-sharded); "local", whole, each
        rank using it for its own part (a model-sharded dim gathered, else
        copied; backward: the partial grads summed); "same", whole, every
        rank using it alike; "norm", a norm scale or a bias added after a
        row product: "local" under SP (each rank's own tokens), else
        "same". A carrier (`dtype` the carriers') of a leaf stored wider
        than the compute dtype (f32 masters) takes the compute dtype's
        value, as the unsharded layer's cast does, its grad rounding
        after the sums; `rounds=False` keeps the stored value, for a leaf
        the unsharded layer reads as stored (a norm scale, the lookup's
        rows)."""
        return self.params([w], [spec], [plan], [dtype], [rounds])[0]

    def params(self, ws, specs, plans, dtypes, rounds=None):
        """`param` of several leaves, their data-axis collectives in one
        bucket per dtype each way (a layer's leaves as it reaches them)."""
        r = self.resolver.rules
        data, model = self._entry(r.data_axes), self._entry(r.model_axes)
        specs = [tuple(sp) + (None,) * (w.dim() - len(sp))
                 for w, sp in zip(ws, specs)]
        acc, rounds = self.acc, rounds or [True] * len(ws)
        ws = [w.to(self.dtype) if acc is not None and dt == acc and r else w
              for w, dt, r in zip(ws, dtypes, rounds)]
        if self.data_axis.size > 1:
            for dt in dict.fromkeys(dtypes):
                sharded = [i for i, sp in enumerate(specs)
                           if data in sp and dtypes[i] == dt]
                whole = [i for i, sp in enumerate(specs)
                         if data not in sp and dtypes[i] == dt]
                if sharded:
                    out = shd.gather_many([ws[i] for i in sharded],
                                          [specs[i].index(data)
                                           for i in sharded],
                                          self.data_axis, dt)
                    for i, o in zip(sharded, out):
                        ws[i] = o
                if whole:
                    out = shd.copy_to_many([ws[i].to(dt) for i in whole],
                                           self.data_axis)
                    for i, o in zip(whole, out):
                        ws[i] = o
        axis = self.model_axis
        if axis.size == 1:
            return [w.to(dt) for w, dt in zip(ws, dtypes)]
        out = []
        for w, sp, plan, dt in zip(ws, specs, plans, dtypes):
            if plan == "norm":
                plan = "local" if self.sp else "same"
            sd = next((d for d, e in enumerate(sp) if e == model), None)
            if plan == "own":
                plan = "same" if sd is None else sd
            if sd is not None and sd == plan:
                out.append(w.to(dt))
                continue
            if sd is not None:
                w = shd.gather(w, sd, axis,
                               "slice" if plan == "same" else "sum", dtype=dt)
            elif plan != "same":
                w = shd.copy_to(w.to(dt), axis)
            if isinstance(plan, int):
                w = shd._block(w, plan, axis)
            out.append(w.to(dt))
        return out

    def layer_params(self, cfg, lp, tokens: int):
        """A layer stack's layer (its slice of the stacked leaves) in its
        blocks' layouts (`params`, `_layer_plans`), as carriers where the
        layers take them; where KV < TP each rank's kv heads of the whole
        k/v leaves (a decode by blocks of the head dim keeps the stored
        blocks instead). The MoE leaves keep their stored dtype, as the
        reference's shard_map body takes the half params, and their grads
        sum in it (`moe.moe_mlp_ep`); a rank keeps its experts where
        `tokens`, the data shard's that the layer routes, take expert
        parallelism (`expert_parallel`), else every expert is
        gathered."""
        tp = self.tp_size()
        specs = tree_util.tree_map(lambda w, sp: tuple(sp)[1:], lp,
                                   self.specs["layers"])
        dt = self.acc or self.dtype
        moe = "router" in lp["mlp"] and tp > 1
        hd_decode = self.decode and self.cache_split(cfg) == "head_dim"
        ep = self.expert_parallel(cfg, tokens)
        flat = tree_util.flatten_with_path(lp)
        out = tree_util.unflatten_like(lp, self.params(
            [w for _, w in flat], bridge.spec_leaves(lp, specs),
            tree_util.leaves(_layer_plans(cfg, tp, lp, hd_decode, ep)),
            [w.dtype if moe and p.startswith("['mlp']") else dt
             for p, w in flat], [not p.startswith("['ln") for p, _ in flat]))
        H, KV = cfg.num_heads, cfg.num_kv_heads
        if tp > 1 and H % tp == 0 and KV % tp and not hd_decode:
            lo, hi = _kv_heads(H, KV, tp, self.model_axis.index)
            ap = out["attn"]
            out["attn"] = dict(ap, **{
                n: ap[n].narrow(0 if n[0] == "b" else 1, lo, hi - lo)
                for n in ("wk", "wv", "bk", "bv") if n in ap})
        return out

    def top_params(self, cfg, params):
        """(params with the embedding's lookup rows and the final norm in
        their layouts, the head's params): the lookup reads the stored
        (bf16) rows and the head the carriers (the reference's take on the
        half params, its head on their cast; tied, one leaf for both where
        the two are the same tensor), each rank its vocab block where the
        vocab splits, else whole and alike; the final norm as a norm."""
        if cfg.block_pattern or cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"the {cfg.family} family's layers have no model axis in "
                "the port (dense, moe and vlm do; hybrid, ssm and audio "
                "not yet)")
        vp = self.vocab_parallel(cfg)
        emb, spec = params["embed"], self.specs["embed"]
        dt = self.acc or self.dtype
        look = self.param(emb["tok"], spec["tok"], 0 if vp else "same",
                          emb["tok"].dtype, rounds=False)
        key = "tok" if cfg.tie_embeddings else "head"
        same = key == "tok" and look.dtype == dt == self.dtype
        head = look if same else self.param(
            emb[key], spec[key], (0 if key == "tok" else 1) if vp
            else "same", dt)
        final_ln = self.param(params["final_ln"], self.specs["final_ln"],
                              "norm", dt, rounds=False)
        return (dict(params, embed={"tok": look}, final_ln=final_ln),
                {key: head})


def _layer_plans(cfg, tp: int, lp, hd_decode: bool, ep: bool):
    """Each leaf's `ShardCtx.param` plan in one layer of a dense or moe
    stack at `tp` model ranks; `hd_decode`, a decode by blocks of the
    head dim (the attention's stored blocks); `ep`, the experts split
    (expert parallelism), else gathered."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if hd_decode:
        attn = {n: "own" for n in ("wq", "bq", "wo", "wk", "wv", "bk", "bv")}
    elif H % tp == 0:
        kv = (lambda d: d) if KV % tp == 0 else (lambda d: "local")
        attn = {"wq": 1, "bq": 0, "wo": 0, "wk": kv(1), "wv": kv(1),
                "bk": kv(0), "bv": kv(0)}
    else:                               # batch_dm: every weight whole
        attn = {n: "local" for n in ("wq", "bq", "wo", "wk", "wv", "bk",
                                     "bv")}
    if "router" in lp["mlp"]:
        mlp = {"router": "same", **{n: 0 if ep else "same"
                                    for n in ("w_gate", "w_up", "w_down")}}
    elif cfg.d_ff % tp == 0:
        mlp = {"w_gate": 1, "w_up": 1, "b_up": 0, "w_down": 0,
               "b_down": "norm"}
    else:                               # computed whole on every rank
        mlp = {n: "norm" for n in lp["mlp"]}
    return {"attn": {n: attn[n] for n in lp["attn"]},
            "mlp": {n: mlp[n] for n in lp["mlp"]},
            "ln1": "norm", "ln2": "norm"}


def _act(ctx, x, *logical):
    return x if ctx is None else ctx.act(x, *logical)


def _kv_heads(H: int, KV: int, tp: int, m: int) -> Tuple[int, int]:
    """[lo, hi): the kv heads model rank m's H / tp q heads read (GQA: q
    head j reads kv head j // (H / KV)), when they group evenly."""
    Hl, G = H // tp, H // KV
    lo, hi = m * Hl // G, ((m + 1) * Hl - 1) // G + 1
    n = hi - lo
    if Hl % n or any((m * Hl + j) // G - lo != j // (Hl // n)
                     for j in range(Hl)):
        raise NotImplementedError(
            f"{H} q heads over {tp} model ranks do not read {KV} kv heads "
            "in even groups")
    return lo, hi


def _attention_dispatch(cfg, q, k, v, window: int = 0):
    """The reference's dispatch: attention_impl="pallas", the flash kernel
    K2 (its plain version on the CPU); else a window shorter than S, the
    chunked windowed form; else S > CHUNKED_THRESHOLD, the chunked causal
    form; else exact attention with the (S, S) scores."""
    S = q.shape[1]
    if cfg.attention_impl == "pallas":
        return ops.flash_attention(q, k, v, causal=True, window=window)
    if window and S > window:
        return nn.chunked_window_attention(q, k, v, window)
    if S > nn.CHUNKED_THRESHOLD:
        return nn.chunked_causal_attention(q, k, v)
    return nn.causal_attention(q, k, v, window)


def _attn_full(cfg, ln, ap, x, sin, cos, window: int = 0, ctx=None):
    """Pre-norm attention sub-block over the full sequence. Returns
    (x + attn, k, v) with k rotated, as the decode cache stores them.
    Under a sharded `ctx` (the reference's hints): q, k, v column-parallel
    over the rank's heads (params as `ShardCtx.layer_params` lays them
    out), the out product row-parallel, then the sum; where the heads do
    not split, the rank's rows of the batch with every weight whole
    (`batch_dm`)."""
    h = nn.rms_norm(x, ln, cfg.norm_eps)
    rows = "batch_dm" if ctx is not None and ctx.batch_dm(cfg) else "batch"
    h = _act(ctx, h, rows, None, None)
    rd = None if ctx is None else ctx.rounds
    q, k, v = nn.qkv_project(cfg, ap, h, rd)
    q = nn.apply_rope(q, sin, cos)
    k = nn.apply_rope(k, sin, cos)
    o = _attention_dispatch(cfg, q, k, v, window)
    o = nn.out_project(cfg, ap, o, None if rd is None else ctx.acc)
    return x + _act(ctx, o, rows, "seq", None), k, v


def _mlp_sub(cfg, lp, x, groups: int = 1, ctx=None):
    """Pre-norm MLP (or MoE) sub-block -> (x + mlp, moe aux or None). A MoE
    layer routes the rows as `groups` dispatch groups, or over the model
    group of `ctx` (`moe.moe_mlp`; under SP on the whole sequence). Under
    a sharded `ctx` the MLP is column- then row-parallel, the GELU form's
    down bias added once after the sum; where d_ff does not split, every
    rank computes the whole MLP on its own tokens."""
    h = nn.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if _is_moe(cfg) and "router" in lp["mlp"]:
        if ctx is not None:
            h = ctx.whole_seq(h)
        o, aux = moe_lib.moe_mlp(cfg, lp["mlp"], h, groups, ctx=ctx)
        return x + (o if ctx is None else ctx.own_seq(o)), aux
    rd = None if ctx is None else ctx.rounds
    if rd is not None and cfg.d_ff % ctx.tp_size():
        return x + nn.mlp(cfg, lp["mlp"], h.to(ctx.acc), out_dtype=rd), None
    h = _act(ctx, h, "batch", None, None)
    p = lp["mlp"]
    o = _act(ctx, nn.mlp(cfg, p, h, down_bias=rd is None, out_dtype=rd),
             "batch", "seq", None)
    if rd is not None and "b_down" in p:
        o = nn.bias_add(o, p["b_down"], rd)
    return x + o, None


def _attn_decode(cfg, ln, ap, x, kc, vc, sin, cos, pos, row_blocks: int = 1,
                 window: int = 0, ctx=None):
    """One attention block, single token; kc/vc (B,T,KV,hd) are written in
    place (`layers.cache_update`). Under a sharded `ctx` (the reference's
    decode hints, `transformer.py:428-453`) h is whole on every rank of the
    model group, kc/vc are the rank's block of the cache and the out
    product is summed over the ranks; the layout follows the cache
    (`ShardCtx.cache_split`): by the rank's heads where the kv heads
    split, as the full-sequence attention runs them, else by blocks of
    the head dim (`_attn_decode_hd`)."""
    h = _act(ctx, nn.rms_norm(x, ln, cfg.norm_eps), "batch", None, None)
    rd = None if ctx is None else ctx.rounds
    q, k, v = nn.qkv_project(cfg, ap, h, rd)
    if ctx is not None and ctx.cache_split(cfg) == "head_dim":
        o = _attn_decode_hd(cfg, ap, q, k, v, kc, vc, sin, cos, pos, ctx)
    else:
        q = nn.apply_rope(q, sin, cos)
        k = nn.apply_rope(k, sin, cos)
        kc, vc = nn.cache_update(kc, vc, k, v, pos, window=window)
        o = _decode_attention(q, kc, vc, pos, row_blocks, window)
    o = nn.out_project(cfg, ap, o, None if rd is None else ctx.acc)
    return x + _act(ctx, o, "batch", "seq", None)


def _attn_decode_hd(cfg, ap, q, k, v, kc, vc, sin, cos, pos, ctx):
    """`_attn_decode`'s attention where the model ranks split the cache's
    head dim: the rank holds a block of every head's dims. RoPE turns dim
    i with dim i + hd/2, which a block does not hold, so the rank's q and
    k products (on its stored blocks of wq and wk, by heads or by head
    dims) are gathered whole over the ranks (one `tp_rope` collective of
    (B, 1, H + KV, hd) values, where gathering the weights would move them
    every step), rotated where each head is whole, and the rank keeps its
    block of dims; v takes its block directly. The partial scores are
    summed over the ranks in f32 and scaled by the whole head dim's
    1/sqrt(hd) (`layers.decode_attention(axis=)`); PV runs on the rank's
    block of v. Returns the input of the out product: that block where wo
    is stored by head dims, else the rank's heads of the output gathered
    whole."""
    axis, H = ctx.model_axis, cfg.num_heads
    q, k = shd.all_gather_many([q, k], [3 if q.shape[2] == H else 2, 3],
                               axis, "tp_rope")
    q, k = (shd._block(nn.apply_rope(t, sin, cos), 3, axis).contiguous()
            for t in (q, k))
    kc, vc = nn.cache_update(kc, vc, k, v, pos)
    o = nn.decode_attention(q, kc, vc, pos, axis=axis, head_dim=cfg.head_dim)
    if ap["wo"].shape[0] != H:
        o = shd._block(shd.all_gather(o, 3, axis, "tp_gather"), 2, axis)
    return o


def _group_full(cfg, gp, x, sin, cos, pattern, max_len: Optional[int] = None,
                cache_dtype=torch.bfloat16):
    """One (sliced) pattern group over the full sequence. With `max_len`
    also returns the group's decode states (prefill), else None."""
    states = {} if max_len is not None else None
    W = cfg.window_size
    for i, kind in enumerate(pattern):
        name = f"b{i}_{kind}"
        lp = gp[name]
        if kind == "attention":
            x, k, v = _attn_full(cfg, lp["ln"], lp["core"], x, sin, cos, W)
            if states is not None:
                states[name] = {"k": _ring(k, W, max_len, cache_dtype),
                                "v": _ring(v, W, max_len, cache_dtype)}
        else:
            h = nn.rms_norm(x, lp["ln"], cfg.norm_eps)
            o, st = _state_block(cfg, kind, lp["core"], h)
            x = x + o
            if states is not None:
                states[name] = st
        if "mlp" in lp:
            x, _ = _mlp_sub(cfg, lp, x)
    return x, states


def _state_block(cfg, kind: str, core, h, state=None):
    """A recurrent-state block (recurrent, mlstm or slstm) over h ->
    (output, its decode state as the cache's leaves, f32). With `state`
    (those leaves) it is one decode step; the state comes back as new
    tensors, never written in place."""
    decode = state is not None
    st = state or {}
    if kind == "recurrent":
        o, (cs, hs) = rec_lib.recurrent_block(
            cfg, core, h, conv_state=st.get("conv"), h_state=st.get("h"),
            decode=decode)
        return o, {"conv": cs.float(), "h": hs}
    if kind == "mlstm":
        o, (cs, (C, n, m)) = xlstm_lib.mlstm_block(
            cfg, core, h, decode=decode,
            state=(st["conv"], (st["C"], st["n"], st["m"])) if decode
            else None)
        return o, {"conv": cs.float(), "C": C, "n": n, "m": m}
    o, (cs, (c, n2, hh, m)) = xlstm_lib.slstm_block(       # slstm
        cfg, core, h, decode=decode,
        state=(st["conv"], (st["c"], st["n2"], st["h"], st["m"]))
        if decode else None)
    return o, {"conv": cs.float(), "c": c, "n2": n2, "h": hh, "m": m}


def _ring(k, W: int, max_len: int, cache_dtype):
    """A prefill's (B, S, KV, hd) keys (or values) as a decode cache of
    T = min(W, max_len) rows holding position p at ring slot p % W (the
    last min(W, S) positions), or of max_len rows without a window. When
    S > W the last W positions, which start at S - W, are the slots rolled
    by S % W."""
    B, S, KV, hd = k.shape
    if not W:
        c = torch.zeros((B, max_len, KV, hd), dtype=cache_dtype,
                        device=k.device)
        c[:, :S] = k.to(cache_dtype)
        return c
    T = min(W, max_len)
    if S >= W:
        return torch.roll(k[:, S - W:].to(cache_dtype), shifts=S % W, dims=1)
    c = torch.zeros((B, T, KV, hd), dtype=cache_dtype, device=k.device)
    c[:, :S] = k.to(cache_dtype)
    return c


def _group_decode(cfg, gp, gc, x, sin, cos, pos, pattern,
                  row_blocks: int = 1):
    """One (sliced) pattern group, single token. Attention caches are
    written in place (the attention per block of rows); recurrent states
    come back as new tensors (their rows are independent)."""
    new = {}
    for i, kind in enumerate(pattern):
        name = f"b{i}_{kind}"
        lp, c = gp[name], gc[name]
        if kind == "attention":
            x = _attn_decode(cfg, lp["ln"], lp["core"], x, c["k"], c["v"],
                             sin, cos, pos, row_blocks, cfg.window_size)
        else:
            h = nn.rms_norm(x, lp["ln"], cfg.norm_eps)
            o, new[name] = _state_block(cfg, kind, lp["core"], h, state=c)
            x = x + o
        if "mlp" in lp:
            x, _ = _mlp_sub(cfg, lp, x)
    return x, new


# ---------------------------------------------------------------------------
# Full forward (train / prefill trunk)
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens, frontend_embeds=None, ctx=None):
    """The token rows, the frontend's embeddings first when given. Under a
    sharded `ctx`, in the residual layout: a vocab-parallel lookup (each
    rank's vocab rows, zeros for the others') summed over the model ranks
    before the frontend's rows join, which that sum would count tp times,
    then (SP) the rank's part of the sequence."""
    sharded = ctx is not None and ctx.sharded
    lo = None
    if sharded and ctx.vocab_parallel(cfg):
        lo = ctx.model_axis.index * params["embed"]["tok"].shape[0]
    x = nn.embed_tokens(cfg, params["embed"], tokens, lo)
    if lo is not None:
        if frontend_embeds is None:     # the sum (SP: the reduce-scatter)
            return ctx.act(x, "batch", "seq", None)
        x = shd.reduce_from(x, ctx.model_axis)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return ctx.own_seq(x) if sharded else x


def remat_group_size(cfg) -> int:
    """Layers per remat group of a layer stack (the reference's): the
    largest divisor of num_layers <= 8; 1 disables grouping (no remat, or
    pattern groups, which are their own blocks)."""
    if cfg.remat == "none" or cfg.block_pattern:
        return 1
    for g in range(min(8, cfg.num_layers), 0, -1):
        if cfg.num_layers % g == 0:
            return g
    return 1


def _dense_layer(cfg, lp, x, sin, cos, ctx=None):
    """One layer of a stack over the full sequence -> (x, k, v, aux). A
    sharded `ctx` first brings the rank's blocks of the layer's params to
    their layouts (`ShardCtx.layer_params`)."""
    if ctx is not None and ctx.sharded:
        # the data shard's tokens: its rows times the whole sequence
        lp = ctx.layer_params(cfg, lp, tokens=x.shape[0] * sin.shape[0])
    x, k, v = _attn_full(cfg, lp["ln1"], lp["attn"], x, sin, cos, ctx=ctx)
    x, aux = _mlp_sub(cfg, lp, x, ctx=ctx)
    return x, k, v, aux


_AUX = ("moe_aux", "moe_drop_frac")


def _layer_block(cfg, template, sin, cos, ctx):
    """A remat body of one layer: (x, *its param leaves) -> (x[, moe aux,
    drop fraction])."""
    def body(x, *leaves):
        lp = tree_util.unflatten_like(template, leaves)
        x, _, _, aux = _dense_layer(cfg, lp, x, sin, cos, ctx)
        return (x,) if aux is None else (x, *(aux[n] for n in _AUX))
    return body


def _stack_hidden(cfg, params, x, sin, cos, collect_kv: bool, ctx=None):
    """The layer stack under cfg.remat -> (x, kv or None, aux). `none` and
    `collect_kv` (prefill) run the layers flat. Otherwise the stack runs
    as remat blocks of G = `remat_group_size` layers (the reference's
    two-level groups): a group is one block under the policy and, inside
    its rerun, each layer a block of its own under `full` (the
    reference's inner `nothing_saveable`); with G = 1 each layer is one
    block under the policy."""
    auxes = []
    if collect_kv or cfg.remat == "none":
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, k, v, aux = _dense_layer(cfg, layer_params(params, i), x,
                                        sin, cos, ctx)
            if collect_kv:
                ks.append(k)
                vs.append(v)
            if aux is not None:
                auxes.append([aux[n] for n in _AUX])
        kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    else:
        kv = None
        layers = params["layers"]
        template = layer_params(params, 0)
        flat = tree_util.leaves(layers)
        G = remat_group_size(cfg)
        layer = _layer_block(cfg, template, sin, cos, ctx)
        if G == 1:
            for i in range(cfg.num_layers):
                x, *aux = remat(layer, cfg.remat, x, *[a[i] for a in flat])
                if aux:
                    auxes.append(aux)
        else:
            for g in range(cfg.num_layers // G):
                x, *aux = remat(layer, cfg.remat, x,
                                *[a[g * G:(g + 1) * G] for a in flat],
                                layers=G)
                auxes += [aux[j:j + len(_AUX)]
                          for j in range(0, len(aux), len(_AUX))]
    aux_out = ({n: torch.mean(torch.stack([a[j] for a in auxes]))
                for j, n in enumerate(_AUX)} if auxes else {})
    return x, kv, aux_out


def lm_hidden(cfg, params, tokens, frontend_embeds=None,
              collect_kv: bool = False, ctx=None):
    """tokens: (B, S_text); frontend_embeds: (B, P, D) or None ->
    (hidden (B,S,D), kv or None, aux dict), S = P + S_text. kv is (k, v),
    each (L, B, S, KV, hd), when `collect_kv` (layer stacks only); aux holds
    the moe family's `moe_aux` and `moe_drop_frac`, each the mean over
    layers. `ctx` (a `ShardCtx`) reaches every layer: one without specs
    the MoE sub-block's experts, a sharded one every layer of a dense or
    moe stack (with the embedding's params that `lm_loss` lays out, a
    vocab-parallel lookup summed over the model ranks, `_embed`). Under
    grad mode the layers run as remat blocks of `cfg.remat`
    (`models/remat.py`): each pattern group (and the tail) one block, as
    the reference's `gbody`/`tbody`; a layer stack in two-level groups
    (`_stack_hidden`)."""
    x = _embed(cfg, params, tokens, frontend_embeds, ctx)
    S = tokens.shape[1] + (0 if frontend_embeds is None
                           else frontend_embeds.shape[1])
    sin, cos = nn.rope_tables(torch.arange(S, device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    kv, aux_out = None, {}
    if cfg.block_pattern:
        for _, pat, stack, depth in _stages(cfg, params):
            template = _slice(stack, 0)
            flat = tree_util.leaves(stack)

            def gbody(x, *leaves, pat=pat, template=template):
                gp = tree_util.unflatten_like(template, leaves)
                return (_group_full(cfg, gp, x, sin, cos, pat)[0],)

            for g in range(depth):
                x, = remat(gbody, cfg.remat, x, *[a[g] for a in flat])
    else:
        x, kv, aux_out = _stack_hidden(cfg, params, x, sin, cos, collect_kv,
                                       ctx)
    x = nn.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, kv, aux_out


def lm_loss(cfg, params, batch, ctx=None):
    """batch: {"tokens": (B,S), "targets": (B,S), ["frontend_embeds"]} ->
    (loss, metrics). The loss covers text positions only; moe adds
    0.01 * moe_aux. Sequences longer than CE_CHUNK stream the head + CE
    over seq chunks, so the (B,S,V) logits never exist. The backward is
    autograd's; the flash kernel K2 has no backward, as in the reference
    (whose Pallas kernel has no VJP), so `attention_impl="pallas"` cannot
    train. A sharded `ctx` takes this rank's blocks of the params and its
    rows of the batch (`ShardCtx.top_params`); where the vocab splits over
    the model ranks the head + CE is vocab-parallel
    (`layers.vocab_parallel_cross_entropy`): no rank holds the (B, S, V)
    logits."""
    if cfg.attention_impl == "pallas":
        raise NotImplementedError(
            "attention_impl='pallas' has no backward (K2 is forward-only, as "
            "the reference's Pallas kernel is): train with 'xla'")
    emb = params["embed"]
    if ctx is not None and ctx.sharded:
        params, emb = ctx.top_params(cfg, params)
    fe = batch.get("frontend_embeds")
    h, _, aux = lm_hidden(cfg, params, batch["tokens"], fe, ctx=ctx)
    vp = ctx is not None and ctx.vocab_parallel(cfg)
    if vp:                            # the whole sequence, as carriers
        h = ctx.act(h, "batch", None, None)
    elif ctx is not None and ctx.sharded:
        h = ctx.whole_seq(h)
    if fe is not None:
        h = h[:, fe.shape[1]:, :]     # text positions only
    if vp:
        loss = nn.vocab_parallel_cross_entropy(
            cfg, next(iter(emb.values())), h, batch["targets"],
            ctx.model_axis, dtype=ctx.rounds)
    else:
        if h.shape[1] > nn.CE_CHUNK:
            loss = nn.chunked_cross_entropy(cfg, emb, h, batch["targets"])
        else:
            logits = nn.logits_from_hidden(cfg, emb, h)
            loss = nn.cross_entropy_loss(logits, batch["targets"])
    metrics = {"loss": loss, **aux}
    if "moe_aux" in aux:
        loss = loss + 0.01 * aux["moe_aux"]
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode cache, decode step, prefill
# ---------------------------------------------------------------------------

def _layers(n: int, leaves):
    """n stacked copies (a leading layer axis) of each leaf."""
    return {k: t.unsqueeze(0).repeat(n, *([1] * t.dim()))
            for k, t in leaves.items()}


def _group_cache(cfg, pattern, n: int, batch: int, max_len: int,
                 cache_dtype, device):
    c = {}
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    for i, kind in enumerate(pattern):
        name = f"b{i}_{kind}"
        if kind == "attention":
            T = min(cfg.window_size, max_len) if cfg.window_size else max_len
            shape = (n, batch, T, KV, hd)
            c[name] = {
                "k": torch.zeros(shape, dtype=cache_dtype, device=device),
                "v": torch.zeros(shape, dtype=cache_dtype, device=device)}
        elif kind == "recurrent":
            conv, h = rec_lib.init_recurrent_state(cfg, batch, device)
            c[name] = _layers(n, {"conv": conv, "h": h})
        elif kind == "mlstm":
            conv, (C, nn_, m) = xlstm_lib.init_mlstm_state(cfg, batch, device)
            c[name] = _layers(n, {"conv": conv, "C": C, "n": nn_, "m": m})
        else:
            conv, (cc, n2, h, m) = xlstm_lib.init_slstm_state(cfg, batch,
                                                              device)
            c[name] = _layers(n, {"conv": conv, "c": cc, "n2": n2, "h": h,
                                  "m": m})
    return c


def init_cache(cfg, batch: int, max_len: int,
               cache_dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """An all-zero decode cache: {"k", "v"} (L, batch, max_len, KV, hd) for
    a layer stack; for pattern groups {"groups", ["tail"]}, each block
    {"k", "v"} (n, batch, T, KV, hd) with T = min(window, max_len), or its
    f32 recurrent state: recurrent {"conv" (n, batch, conv_width - 1,
    d_rnn), "h" (n, batch, d_rnn)}; mlstm {"conv", "C" (n, batch, H, hd,
    hd), "n" (n, batch, H, hd), "m" (n, batch, H)}; slstm {"conv", "c",
    "n2", "h", "m", each (n, batch, d_model) but conv}, with m at -1e30."""
    check_family(cfg)
    if cfg.block_pattern:
        pat = tuple(cfg.block_pattern)
        cache = {"groups": _group_cache(cfg, pat, cfg.num_layers // len(pat),
                                        batch, max_len, cache_dtype, device)}
        tail = pattern_tail(cfg)
        if tail:
            cache["tail"] = _group_cache(cfg, tail, 1, batch, max_len,
                                         cache_dtype, device)
        return cache
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


def _decode_attention(q, kc, vc, pos, row_blocks: int, window: int = 0):
    """Decode attention over `row_blocks` equal blocks of rows, one call
    each: a block of B rows then runs the very batched products a B-row
    decode runs (cuBLAS picks its algorithm by the batch count, so the
    stacked replicas of the fused backend would otherwise get other
    bits than a replica decoded alone)."""
    if row_blocks == 1:
        return nn.decode_attention(q, kc, vc, pos, window)
    n = q.shape[0] // row_blocks
    outs = []
    for r in range(row_blocks):
        rows = slice(r * n, (r + 1) * n)
        p = (nn.RowPositions(hit=pos.hit[rows], visible=pos.visible[rows])
             if isinstance(pos, nn.RowPositions) else pos)
        outs.append(nn.decode_attention(q[rows], kc[rows], vc[rows], p,
                                        window))
    return torch.cat(outs)


def _ring_slots(cfg, cache) -> Optional[int]:
    """T of the pattern families' attention caches (a ring of min(window,
    max_len) slots, or max_len rows without a window), None without
    attention blocks."""
    for part in ("groups", "tail"):
        for name, c in cache.get(part, {}).items():
            if name.endswith("_attention"):
                return c["k"].shape[2]
    return None


def lm_decode_step(cfg, params, cache, tokens, pos, row_blocks: int = 1,
                   ctx=None):
    """One serve step. tokens: (B,); pos: 0-based absolute position of this
    token, a host int shared by every row or a (B,) device tensor of
    per-row positions (continuous serving's slots; no host read). Returns
    (logits (B,V), cache). KV caches, dense or ring, are updated in place
    (see layers.cache_update); the pattern families' recurrent states come
    back as new tensors in a new cache dict, so the cache that was passed
    in still holds the states the step started from. `row_blocks` > 1
    (the fused backend's replicas) computes the attention block by block
    (`_decode_attention`).

    A MoE layer routes as the reference's vmapped decodes do: per-row
    positions are `serve()`'s slots, each its own dispatch group (one
    token, capacity 4); a host-int position routes each block of rows as
    one group.

    The blocks keep their bits: the ops whose result for a row depends on
    how many rows run beside it run once per block (`layers.row_blocks`),
    so a block's logits and cache equal those of its rows decoded
    alone.

    `ctx` (a sharded `ShardCtx`, the reference's argument): the step on a
    rank of a process mesh, under the reference's decode hints
    (`ShardCtx.decode`): tokens (B,) the rank's data shard, the cache the
    rank's block of every leaf, `pos` a host int. The lookup
    vocab-parallel where the vocab splits (summed over the model ranks);
    the residual stream whole on every rank of the model group; attention
    laid out as the cache is (`_attn_decode`); the MLP column- then
    row-parallel, a MoE layer over the model group where its B tokens
    split (`ShardCtx.expert_parallel`), else each data shard routing as
    one group. The logits are the rank's vocab block (B, V / tp) where the
    vocab splits, else (B, V). On a mesh of one rank, the code without
    `ctx`, bit for bit."""
    if ctx is None or ctx.acc is None:
        ctx = None
    else:
        if row_blocks != 1:
            raise ValueError("a sharded decode step takes one block of rows")
        if isinstance(pos, torch.Tensor):
            raise NotImplementedError("a sharded decode step takes one "
                                      "host-int position (the reference's "
                                      "scalar)")
        if ctx.tp_size() > 1 and ctx.cache_split(cfg) is None:
            raise NotImplementedError(
                f"{cfg.num_kv_heads} kv heads and a head dim of "
                f"{cfg.head_dim} do not split over {ctx.tp_size()} model "
                "ranks")
        ctx = dataclasses.replace(ctx, decode=True)
    with nn.row_blocks(row_blocks):
        return _decode_step(cfg, params, cache, tokens, pos, row_blocks, ctx)


def _decode_step(cfg, params, cache, tokens, pos, row_blocks: int,
                 ctx=None):
    if ctx is not None:
        params, head = ctx.top_params(cfg, params)
    x = _embed(cfg, params, tokens[:, None], ctx=ctx)
    groups = row_blocks
    if isinstance(pos, torch.Tensor):
        groups = tokens.shape[0]
        sin, cos = nn.rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
        T = (_ring_slots(cfg, cache) if cfg.block_pattern
             else cache["k"].shape[2])
        pos = (nn.row_positions(pos, T, cfg.window_size if cfg.block_pattern
                                else 0) if T else None)
    else:
        sin, cos = nn.rope_tables(torch.arange(pos, pos + 1, device=x.device),
                                  cfg.head_dim, cfg.rope_theta)
    if cfg.block_pattern:
        new_cache = {}
        for part, pat, stack, depth in _stages(cfg, params):
            stacked = cache[part]
            news = []
            for g in range(depth):
                x, new = _group_decode(cfg, _slice(stack, g),
                                       _slice(stacked, g), x, sin, cos, pos,
                                       pat, row_blocks)
                news.append(new)
            new_cache[part] = {
                name: (_stack([n[name] for n in news])
                       if name in news[0] else stacked[name])
                for name in stacked}
        cache = new_cache
    else:
        for i in range(cfg.num_layers):
            lp = layer_params(params, i)
            if ctx is not None:
                lp = ctx.layer_params(cfg, lp, tokens=tokens.shape[0])
            x = _attn_decode(cfg, lp["ln1"], lp["attn"], x, cache["k"][i],
                             cache["v"][i], sin, cos, pos, row_blocks,
                             ctx=ctx)
            x, _ = _mlp_sub(cfg, lp, x, groups, ctx=ctx)
    x = nn.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if ctx is not None:
        return _logits_tp(cfg, ctx, head, x)[:, 0, :], cache
    logits = nn.logits_from_hidden(cfg, params["embed"], x)[:, 0, :]
    return logits, cache


def _logits_tp(cfg, ctx, head, h):
    """A rank's logits of h (B, s, D): the head's block (`ShardCtx.
    top_params`: the rank's vocab block where the vocab splits, else
    whole) on carriers, rounded to the compute dtype once."""
    w = next(iter(head.values()))
    return nn._head(h.to(ctx.acc), w, cfg.tie_embeddings,
                    ctx.rounds).to(ctx.rounds)


def _cache_block(cfg, ctx, k, v):
    """A prefill's k/v (L, B, S, ., .) from the attention's layout into
    the cache's: the rank's block of kv heads or head dims
    (`ShardCtx.cache_split`) of the data shard's rows. Attention over the
    heads with the kv heads split holds that block already (where the kv
    heads split, so do the heads). Otherwise the ranks' blocks are
    gathered over the model group (one `tp_cache` collective for k and
    v): under `batch_dm` each rank holds its rows with every head, so the
    gather joins the rows; where KV < TP under the heads each rank holds
    the kv heads its q heads read, several ranks the same one, so each kv
    head is taken from the first rank that holds it. The rank then keeps
    its block of head dims."""
    tp, split = ctx.tp_size(), ctx.cache_split(cfg)
    if tp == 1 or split == "kv_heads":
        return k, v
    dm = ctx.batch_dm(cfg)
    axis = ctx.model_axis
    k, v = shd.all_gather_many([k, v], [1 if dm else 3] * 2, axis,
                               "tp_cache")
    if not dm:
        H, KV, n = cfg.num_heads, cfg.num_kv_heads, k.shape[3] // tp
        spans = [_kv_heads(H, KV, tp, r) for r in range(tp)]
        idx = [next(r * n + j - lo for r, (lo, hi) in enumerate(spans)
                    if lo <= j < hi) for j in range(KV)]
        k, v = (t[:, :, :, idx] for t in (k, v))
    if split == "head_dim":
        k, v = (shd._block(t, 4, axis).contiguous() for t in (k, v))
    return k, v


def _prefill_tp(cfg, params, tokens, max_len: int, cache_dtype, lengths,
                frontend_embeds, ctx):
    """`lm_prefill` on a rank of a process mesh (the reference's prefill
    under its hints, `transformer.py:593-658`): the trunk as the sharded
    training forward runs it (`lm_hidden`: attention over the heads, or
    the rows over the model ranks where the heads do not split; SP under
    the rules), the k/v brought into the cache's layout (`_cache_block`)
    and written into the rank's block of a max_len cache; the rank's
    logits of the last position (`_logits_tp`; SP: that position's
    hidden gathered from the rank that holds it)."""
    params, head = ctx.top_params(cfg, params)
    h, (k, v), _ = lm_hidden(cfg, params, tokens, frontend_embeds,
                             collect_kv=True, ctx=ctx)
    k, v = _cache_block(cfg, ctx, k, v)
    L, B, S = k.shape[:3]
    cache = {}
    for name, t in (("k", k), ("v", v)):
        cache[name] = torch.zeros((L, B, max_len) + tuple(t.shape[3:]),
                                  dtype=cache_dtype, device=t.device)
        cache[name][:, :, :S] = t.to(cache_dtype)
    if lengths is not None:
        P = frontend_embeds.shape[1] if frontend_embeds is not None else 0
        h = ctx.whole_seq(h)
        idx = torch.clamp(lengths.to(torch.int64) - 1 + P, 0, S - 1)
        h_last = torch.take_along_dim(h, idx[:, None, None], dim=1)
    elif ctx.sp:
        h_last = shd.all_gather(h[:, -1:].contiguous(), 1, ctx.model_axis,
                                "tp_gather")[:, -1:]
    else:
        h_last = h[:, -1:]
    return _logits_tp(cfg, ctx, head, h_last)[:, 0, :], cache


def lm_prefill(cfg, params, tokens, max_len: int,
               cache_dtype=torch.bfloat16,
               lengths: Optional[torch.Tensor] = None,
               frontend_embeds: Optional[torch.Tensor] = None,
               ctx=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the trunk over the prompt (the frontend's P embeddings first,
    when given) and build the decode cache. Returns (last_logits (B,V),
    cache); decode continues at position P + S.

    `lengths` (B,) enables RIGHT-PADDED prompts (layer stacks only): the
    last hidden state is gathered at each row's true final position.
    Causal attention keeps pad columns out of every real position, and
    decode overwrites slot `pos` before attending it, so the pad entries
    written into the cache beyond `lengths` are never observed. Recurrent
    states and ring-buffer window caches fold in every position, so
    `lengths` raises there.

    `ctx` (a sharded `ShardCtx`, the reference's argument): the prefill on
    a rank of a process mesh (`_prefill_tp`); on a mesh of one rank, the
    code below, bit for bit."""
    if lengths is not None and (cfg.block_pattern or cfg.window_size):
        raise NotImplementedError(
            "length-gathered (right-padded) prefill needs positions to be "
            "skippable; recurrent states and ring-buffer window caches fold "
            "every position in")
    if ctx is not None and ctx.acc is not None:
        return _prefill_tp(cfg, params, tokens, max_len, cache_dtype,
                           lengths, frontend_embeds, ctx)
    if cfg.block_pattern:
        if frontend_embeds is not None:
            raise NotImplementedError("pattern families take no frontend")
        x = _embed(cfg, params, tokens)
        S = x.shape[1]
        sin, cos = nn.rope_tables(torch.arange(S, device=x.device),
                                  cfg.head_dim, cfg.rope_theta)
        cache = {}
        for part, pat, stack, depth in _stages(cfg, params):
            states = []
            for g in range(depth):
                x, st = _group_full(cfg, _slice(stack, g), x, sin, cos, pat,
                                    max_len, cache_dtype)
                states.append(st)
            cache[part] = _stack(states)
        x = nn.rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = nn.logits_from_hidden(cfg, params["embed"], x[:, -1:, :])
        return logits[:, 0, :], cache

    B = tokens.shape[0]
    h, (k, v), _ = lm_hidden(cfg, params, tokens, frontend_embeds,
                             collect_kv=True)
    S = h.shape[1]
    cache = init_cache(cfg, B, max_len, cache_dtype, device=h.device)
    cache["k"][:, :, :S] = k.to(cache_dtype)
    cache["v"][:, :, :S] = v.to(cache_dtype)
    if lengths is None:
        h_last = h[:, -1:, :]
    else:
        P = frontend_embeds.shape[1] if frontend_embeds is not None else 0
        idx = torch.clamp(lengths.to(torch.int64) - 1 + P, 0, S - 1)
        h_last = torch.take_along_dim(h, idx[:, None, None], dim=1)
    logits = nn.logits_from_hidden(cfg, params["embed"], h_last)[:, 0, :]
    return logits, cache
