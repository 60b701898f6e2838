"""Where the fused backend's stacked decode leaves a replica's bits, op by
op, on one NVIDIA GPU, and which einsums must run per replica half to keep
them:

    python3 scripts/stacked_decode_bisect.py [arch ...]

For qwen2-0.5b (the main path, every layer) and each family case of
`chip_smoke.py::FAMILY_CASES` (or the archs named): one prefill of B rows
at the phase's depth and prompt, then up to 8 greedy decode steps of the
B rows alone (`Model.decode_step`) against the 2B stacked rows
(`Model.decode_step(row_blocks=2)`, both halves the same rows), at the
host position and, for moe, hybrid and ssm, at per-row positions. Each
step runs under a dispatch mode that records every aten op's output; the
two op sequences are aligned and each pair is compared on the first B
rows (the first half along the one axis where the stacked output is twice
as long, or the whole output where the shapes agree). Prints, for the
first step where any pair differs, the first such op with the model
source lines that called it (the sequences are aligned by op and calling
line, so that the ops a stacked decode runs once per block of rows pair
with the replica's own), then whether each step's logits agreed.

The search: the model's own per-block ops (`layers.row_blocks`) stay as
they are, and every `torch.einsum` of a stacked decode goes through a
wrapper that runs it once per row block when its calling line (the line
that called `layers.wein`, for a weight product) is in a set that starts
empty. Where the first differing op was called from an einsum line not in
the set, the line joins it and the arch is bisected again, until no op
differs or the op is not an einsum's. Prints the set each arch needs:
the lines to run per block in the model. Also times one stacked decode
step with that set and with every einsum per block, beside a replica's
(CUDA events; the wrapper's host cost in both). Imports nothing of JAX.
"""
import difflib
import os
import subprocess
import sys
import time
import traceback

BIG = 1 << 22          # outputs larger than this are not kept (weight casts)
STEPS = 8
# ops that only view or lay out their input: compared through the op that
# computed the values (a flat buffer's first half is not a group's rows)
VIEWS = {"view", "_unsafe_view", "reshape", "slice", "select", "narrow",
         "unsqueeze", "squeeze", "permute", "transpose", "t", "expand",
         "alias", "as_strided", "detach", "clone", "contiguous", "cat",
         "new_zeros", "index_put_", "index_select", "split", "unbind"}


def _trace_step(fn):
    """Run fn() under a dispatch mode; returns (result, [(op, out or None,
    shape, frames)])."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    log = []

    class Rec(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            t = out[0] if isinstance(out, (tuple, list)) and out and \
                isinstance(out[0], torch.Tensor) else out
            if isinstance(t, torch.Tensor):
                frames = [f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()[:-1]
                          if "repro_torch" in f.filename][-4:]
                name = str(func.overloadpacket.__name__)
                keep = (t.detach().clone() if t.numel() <= BIG
                        and name not in VIEWS else None)
                log.append((name, keep,
                            tuple(t.shape), frames))
            return out

    with Rec():
        res = fn()
    return res, log


def _half(a_shape, b):
    """b's part that corresponds to a tensor of a_shape: b itself when the
    shapes agree, its first half along the one axis where b is twice as
    long, else None."""
    if tuple(b.shape) == tuple(a_shape):
        return b
    if len(b.shape) != len(a_shape):
        return None
    axes = [i for i, (m, n) in enumerate(zip(a_shape, b.shape)) if m != n]
    if len(axes) == 1 and b.shape[axes[0]] == 2 * a_shape[axes[0]]:
        return b.narrow(axes[0], 0, a_shape[axes[0]])
    return None


def _first_diff(la, lb):
    """The first aligned pair whose values differ: (i, j, max |d|) or None,
    and the number of pairs compared."""
    import torch
    def key(x):      # the op and the model lines that called it
        return (x[0], tuple(x[3]))
    sm = difflib.SequenceMatcher(None, [key(x) for x in la],
                                 [key(x) for x in lb], autojunk=False)
    n = 0
    for blk in sm.get_matching_blocks():
        for d in range(blk.size):
            i, j = blk.a + d, blk.b + d
            a, b = la[i][1], lb[j][1]
            if a is None or b is None:
                continue
            hb = _half(a.shape, b)
            if hb is None:
                continue
            if not a.is_floating_point() or la[i][0] in VIEWS or a.dim() == 0:
                continue      # indices differ by design; a scalar is a mean over every group
            n += 1
            same = torch.equal(torch.nan_to_num(a), torch.nan_to_num(hb)) \
                and torch.equal(torch.isnan(a), torch.isnan(hb))
            err = float((a.float() - hb.float()).abs().max())
            if not same:
                return (i, j, err), n
    return None, n


SPLIT = set()    # einsum lines ("file.py:line") run once per row block
SEEN = set()     # einsum lines a stacked decode reached
_SKIP = {"taped", "wein", "<lambda>", "blockwise", "split_einsum"}


def install_split_einsum():
    """Replace torch.einsum by `split_einsum` (see the module docstring)."""
    import torch
    from repro_torch.models import layers
    orig = torch.einsum

    def split_einsum(equation, *ops):
        n = getattr(layers._ROWS, "n", 1)
        if n == 1:
            return orig(equation, *ops)
        f = sys._getframe(1)
        while f is not None and f.f_code.co_name in _SKIP:
            f = f.f_back
        site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
        up = f
        while up is not None:       # attention already runs per block
            if up.f_code.co_name == "_decode_attention":
                return orig(equation, *ops)
            up = up.f_back
        SEEN.add(site)
        if site not in SPLIT:
            return orig(equation, *ops)
        ins, out = equation.replace(" ", "").split("->")
        subs = ins.split(",")
        # the rows: an expert queue's slots, else the first operand's
        # leading index
        row = "c" if equation.startswith("ec") else subs[0][0]

        def block(r):
            args = []
            for sub, t in zip(subs, ops):
                if row in sub:
                    d = sub.index(row)
                    m = t.shape[d] // n
                    t = t.narrow(d, r * m, m)
                args.append(t)
            return orig(equation, *args)
        return torch.cat([block(r) for r in range(n)], dim=out.index(row))
    torch.einsum = split_einsum


def bisect(arch, B, S, depth, per_row: bool, timed: bool):
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    cfg = cs.cut_depth(dataclasses.replace(get_config(arch),
                                           attention_impl="pallas"), depth)
    model = build_model(cfg, dev)
    params = model.init(seed=0)
    rng = np.random.RandomState(7)
    prompt = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S))).to(dev)}
    if cfg.frontend:
        prompt["frontend_embeds"] = 0.1 * torch.from_numpy(
            rng.standard_normal((B, cfg.frontend_seq, cfg.frontend_dim)
                                ).astype(np.float32)).to(dev)
    P = cfg.frontend_seq if cfg.family == "vlm" else 0
    pos = S + P
    with torch.no_grad():
        _, cache0 = model.prefill(params, prompt, pos + STEPS + 8)
        axes = model.slot_axes()
        one = tree_map(lambda c: c.clone(), cache0)
        two = tree_map(lambda c, ax: torch.cat([c, c], dim=ax), cache0, axes)
        tok = prompt["tokens"][:, -1]
        found, agree = None, []
        for s in range(STEPS):
            p1 = (torch.full((B,), pos + s, device=dev) if per_row
                  else pos + s)
            p2 = torch.cat([p1, p1]) if per_row else p1
            tok2 = torch.cat([tok, tok])
            if found is None:
                (l1, one), la = _trace_step(
                    lambda: model.decode_step(params, one, tok, p1))
                (l2, two), lb = _trace_step(
                    lambda: model.decode_step(params, two, tok2, p2,
                                          row_blocks=2))
                d, n = _first_diff(la, lb)
                if d is not None:
                    i, j, err = d
                    found = (s, la[i][0], la[i][2], lb[j][2], err,
                             la[i][3], n, i, len(la), len(lb))
                del la, lb
            else:
                l1, one = model.decode_step(params, one, tok, p1)
                l2, two = model.decode_step(params, two, tok2, p2, row_blocks=2)
            agree.append(torch.equal(l1, l2[:B]) and torch.equal(l1, l2[B:]))
            tok = torch.argmax(l1, -1)
        # one step's device-event time of each layout, the caches as left:
        # the stacked rows with this set of per-block einsums and with
        # every einsum per block
        def t_of(fn):
            return cs.cuda_ms(fn, 5, warmup=2)
        ms = None
        if timed:
            ms1 = t_of(lambda: model.decode_step(params, one, tok, p1))
            ms2 = t_of(lambda: model.decode_step(params, two, tok2, p2,
                                                 row_blocks=2))
            narrow = set(SPLIT)
            SPLIT.update(SEEN)
            ms3 = t_of(lambda: model.decode_step(params, two, tok2, p2,
                                                 row_blocks=2))
            SPLIT.clear()
            SPLIT.update(narrow)
            ms = (ms1, ms2, ms3)
    where = "per-row" if per_row else "host"
    print(f"{arch} ({cfg.family}, {cfg.num_layers} layers, B={B}, "
          f"{where} positions from {pos}): logits of the stacked rows "
          f"bitwise equal to a replica alone per step {agree}", flush=True)
    if found is None:
        print(f"  no op differs over {STEPS} steps", flush=True)
    else:
        s, op, sa, sb, err, frames, n, i, na, nb = found
        print(f"  first differing op at step {s}: aten.{op}, alone "
              f"{sa} vs stacked {sb}, max |d| {err:.3e} (op {i} of {na} "
              f"alone / {nb} stacked; {n} pairs compared before it)",
              flush=True)
        for f in frames:
            print(f"    {f}", flush=True)
    if ms is not None:
        print(f"  one decode step: a replica alone {ms[0]:.3f} ms, the "
              f"stacked 2B rows {ms[1]:.3f} ms with the per-block einsums "
              f"{sorted(SPLIT)}, {ms[2]:.3f} ms with every einsum per block "
              f"(CUDA events)", flush=True)
    del model, params, one, two, cache0
    torch.cuda.empty_cache()
    return found, all(agree)


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(here, "src"))
    sys.path.insert(1, here)
    import chip_smoke as cs       # sets the cuBLAS and allocator env first
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    from repro_torch.device import make_deterministic
    from repro_torch.kernels import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    make_deterministic(torch.device("cuda"))
    _build.build(["flash_attention"])
    install_split_einsum()
    names = sys.argv[1:]
    t0 = time.time()
    for arch, B, S, depth in (("qwen2-0.5b", 4, 256, None),
                              *cs.FAMILY_CASES):
        if names and arch not in names:
            continue
        SPLIT.clear()
        for per_row in (False, True):
            if per_row and not any(k in arch for k in (
                    "moe", "recurrentgemma", "xlstm")):
                continue
            for _ in range(8):
                found, agree = bisect(arch, B, S, depth, per_row, False)
                if found is None:
                    break
                lines = [f.split()[0] for f in found[5]]
                new = [x for x in lines if x in SEEN and x not in SPLIT]
                if not new:
                    print(f"  {arch}: the first differing op is no einsum's "
                          f"(logits equal {agree}); the search stops",
                          flush=True)
                    break
                SPLIT.add(new[-1])
                print(f"  {arch}: now per block: {sorted(SPLIT)}",
                      flush=True)
            bisect(arch, B, S, depth, per_row, True)
        print(f"{arch}: einsum lines to run per row block: {sorted(SPLIT)}",
              flush=True)
    print(f"took {time.time() - t0:.1f} s", flush=True)
