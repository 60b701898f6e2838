"""K1: fused state fingerprint on Hopper, with its plain version beside it.

Replaces `src/repro/kernels/fingerprint.py::fingerprint_pallas` (the
`_fingerprint_kernel` Pallas kernel); the CUDA source is
`src/repro_torch/csrc/fingerprint.cu`, whose header states the bound and the
design. Over the u32 words u_i of a state at global index i:

    h1 = sum_i ((u_i XOR (i*C1)) * C2)        mod 2^32
    h2 = sum_i (t XOR (t >> 15)), t=(u_i+i)*C3 mod 2^32
    s  = sum(float(u_i))  (f32)       a = max(|float(u_i)|)  (f32)

Word carrier: torch has no full uint32 arithmetic, so a buffer of u32 words
travels as an int32 tensor holding the same bits, and a fingerprint is a
(4,) int32 tensor holding the bits of [h1, h2, s, a]. The plain version
widens the words to int64, keeps every intermediate in [0, 2^32), and masks
after each operation; a 32x32-bit product is formed from 16-bit halves of
the constant so that it never leaves the int64 range.

The kernel reads a table of leaves (`leaf_table`): each leaf's elements,
in row-major order, are `rows` runs of `run` contiguous elements spaced
`stride` elements apart, and its first word has global index `base` (the
words of the leaves before it). f32, int32 and uint32 leaves are read as
words, bf16 upcast exactly and int64 value-cast to int32, as
`core.fingerprint._to_u32` packs them, so the hash words and absmax equal
those of the packed buffer bit for bit without building it. A leaf may
carry a row limit (`leaf_table(..., limits=)`): a device int element, read
by the kernel, below which rows are hashed as they are and from which on
every word of each run is hashed as zero at its fixed index, as if the
packed buffer held zeros there. A limit may name a ring of W rows (a
local-attention cache): row `limit % W`, the one the next decode step
overwrites, is then hashed as zero words too. The table holds up to
MAX_LEAVES leaves (a training state's {params, m, v} has up to 126); it
travels in the launch's parameters, a 64-row table where it fits.

Lanes (`lane_table`, `fingerprint_lanes`): the packed words cut into L lanes
of W = ceil(N / L) words, each hashed with its own index stream from 0, the
last lane's tail zero-padded (the reference's `pytree_fingerprint_lanes`).
A leaf that crosses a lane boundary becomes one table row per lane, each
row's `base` its offset within its lane, and the padding comes as rows of
zero words (kind 3); one launch returns (L, 4).

Three wrappers, each with no fallback: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (one launch per call, counted
in `launch_count`) or raises. `fingerprint_u32` hashes one packed word
buffer; `fingerprint_lanes` hashes a lane table, and `fingerprint_leaves`
a table of leaves in place as its one lane.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

C1 = 2654435761
C2 = 2246822519
C3 = 3266489917
MASK32 = 0xFFFFFFFF
THREADS = 256            # csrc/fingerprint.cu THREADS
MAX_BLOCKS = 1024
MAX_LEAVES = 512         # csrc/fingerprint.cu MAX_LEAVES
MAX_LIMITS = 16          # csrc/fingerprint.cu MAX_LIMITS
MAX_LANES = 16           # csrc/fingerprint.cu MAX_LANES
ZEROS = 3                # the kind of a row of zero words (a lane's padding)
_PLAIN_CHUNK = 1 << 24   # words per int64 working chunk of the plain version
# element kind of each dtype the kernel reads in place (csrc/fingerprint.cu)
KINDS = {torch.float32: 0, torch.int32: 0, torch.uint32: 0,
         torch.bfloat16: 1, torch.int64: 2}

launch_count = _build.LaunchCount("fingerprint")


class Leaf(NamedTuple):
    """One row of the kernel's table: `tensor`'s elements from element
    `offset` on, in row-major order, are `rows` runs of `run` contiguous
    elements, `stride` elements apart; its first word has index `base`
    within its `lane` (the global index without lanes). With a row `limit`
    (a 0-d int32/int64 tensor on the leaf's device), the elements of each
    run at or past `limit * per_row` count as zero words; with a `ring` of
    W rows also those of row `limit % W`. A row of kind `ZEROS` has no
    tensor: `run` zero words."""

    tensor: Optional[torch.Tensor]
    kind: int
    rows: int
    run: int
    stride: int
    base: int
    limit: Optional[torch.Tensor] = None
    per_row: int = 0
    ring: int = 0
    lane: int = 0
    offset: int = 0


def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a constant c < 2^32;
    both partial products stay below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _to_carrier(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _plain_parts(u: torch.Tensor, start: int):
    """(h1, h2, s, a) of the 1-D int32 words `u` at global indices
    start, start + 1, ...: h1/h2 int64 in [0, 2^32), s/a f32 (0-d)."""
    dev = u.device
    h1 = torch.zeros((), dtype=torch.int64, device=dev)
    h2 = torch.zeros((), dtype=torch.int64, device=dev)
    s = torch.zeros((), dtype=torch.float32, device=dev)
    a = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, u.numel(), _PLAIN_CHUNK):
        w = u[lo:lo + _PLAIN_CHUNK]
        uc = w.to(torch.int64) & MASK32
        idx = torch.arange(start + lo, start + lo + w.numel(),
                           dtype=torch.int64, device=dev) & MASK32
        h1 = (h1 + _mulmod32(uc ^ _mulmod32(idx, C1), C2).sum()) & MASK32
        t = _mulmod32((uc + idx) & MASK32, C3)
        h2 = (h2 + (t ^ (t >> 15)).sum()) & MASK32
        x = w.view(torch.float32)
        s = s + x.sum()
        a = torch.maximum(a, x.abs().max())
    return h1, h2, s, a


def _carrier(h1, h2, s, a) -> torch.Tensor:
    return torch.cat([_to_carrier(torch.stack([h1, h2])),
                      torch.stack([s, a]).view(torch.int32)])


def fingerprint_plain(u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1 over a 1-D int32 word buffer -> (4,) int32 carrier.
    Runs on the tensor's device."""
    return _carrier(*_plain_parts(u, 0))


def _layout(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(rows, run, stride) if t's elements in row-major order are `rows`
    runs of `run` contiguous elements, `stride` elements apart; else None.
    Size-1 dims are ignored; the innermost dims whose strides make one
    contiguous run form `run`, the rest must merge into one strided dim."""
    dims = [(n, s) for n, s in zip(t.shape, t.stride()) if n != 1]
    run = 1
    while dims and dims[-1][1] == run:
        run *= dims.pop()[0]
    if not dims:
        return 1, run, run
    rows, stride = dims.pop()
    while dims:
        n, s = dims.pop()
        if s != rows * stride:
            return None
        rows *= n
    return rows, run, stride


def _limited_layout(t: torch.Tensor, axis: int
                    ) -> Optional[Tuple[int, int, int]]:
    """(rows, run, stride) with one run per index of the dims before `axis`
    (each run covers t's dims axis..), or None if t cannot be read so."""
    lay = _layout(t)
    period = 1
    for n in t.shape[axis:]:
        period *= n
    if lay is None or period == 0 or lay[1] % period:
        return None
    rows, run, stride = lay
    if run == period:
        return lay
    if rows != 1:
        return None
    return run // period, period, period


def leaf_table(leaves: Sequence[torch.Tensor],
               limits: Optional[Sequence] = None) -> Optional[List[Leaf]]:
    """The kernel's table for `leaves` in order, empty leaves left out, or
    None if a leaf's dtype is not one the kernel reads in place (`KINDS`),
    its layout is not rows x one contiguous run, a leaf holds 2^32 words or
    more, or there are more than MAX_LEAVES non-empty leaves or MAX_LIMITS
    distinct row limits.

    `limits`, beside `leaves`, holds None, `(limit, axis)` or `(limit,
    axis, ring)` per leaf: `limit` a 0-d int32/int64 tensor on the leaf's
    device and `axis` the leaf's row axis. Within each index of the dims
    before `axis`, the rows at or past `limit` (their elements) are hashed
    as zero words; e.g. one slot's cache (L, T, KV, hd) with limit pos[i]
    and axis 1 keeps rows [0, pos[i)) of every layer. A `ring` W > 0 also
    zeroes row `limit % W`: a ring cache's live rows but the next step's."""
    table, base, keys = [], 0, set()
    for j, t in enumerate(leaves):
        kind = KINDS.get(t.dtype)
        if kind is None:
            return None
        if t.numel() == 0:
            continue
        lim = limits[j] if limits is not None else None
        if lim is None:
            lay, extra = _layout(t), ()
        else:
            limit, axis, ring = (*lim, 0)[:3]
            if limit.dim() != 0 or limit.dtype not in (
                    torch.int32, torch.int64) or not 0 <= ring < 2 ** 31:
                return None
            per_row = 1
            for n in t.shape[axis + 1:]:
                per_row *= n
            lay, extra = (_limited_layout(t, axis),
                          (limit, per_row, int(ring)))
            keys.add((limit.data_ptr(), limit.dtype, per_row, int(ring)))
        if lay is None or t.numel() >= 2 ** 32:
            return None
        table.append(Leaf(t, kind, *lay, base, *extra))
        base += t.numel()
    if len(table) > MAX_LEAVES or len(keys) > MAX_LIMITS:
        return None
    return table


def _pieces(leaf: Leaf, lo: int, hi: int) -> List[Leaf]:
    """Rows of the table for elements [lo, hi) of `leaf` (its own row-major
    order): a partial first row, the whole rows, a partial last row."""
    run, stride = leaf.run, leaf.stride

    def row(r0: int, c0: int, rows: int, n: int) -> Leaf:
        return leaf._replace(rows=rows, run=n, stride=stride if rows > 1
                             else n, offset=leaf.offset + r0 * stride + c0)

    out = []
    r0, c0 = divmod(lo, run)
    r1, c1 = divmod(hi, run)
    if r0 == r1:
        return [row(r0, c0, 1, c1 - c0)] if c1 > c0 else []
    if c0:
        out.append(row(r0, c0, 1, run - c0))
        r0 += 1
    if r1 > r0:
        out.append(row(r0, 0, r1 - r0, run))
    if c1:
        out.append(row(r1, 0, 1, c1))
    return out


def lane_table(leaves: Sequence[torch.Tensor],
               n_lanes: int) -> Optional[List[Leaf]]:
    """The kernel's table for the fingerprint lanes of `leaves`: their N
    packed words cut into `n_lanes` lanes of W = ceil(N / n_lanes) words.
    A leaf's words in lane l become a row (or, off a row boundary of a
    strided leaf, up to three) with `lane` l and `base` their offset in it;
    lane l's words past N are `ZEROS` rows. None where `leaf_table` is None
    or the table would exceed MAX_LEAVES rows; ValueError for more than
    MAX_LANES lanes or no words at all."""
    L = max(int(n_lanes), 1)
    if L > MAX_LANES:
        raise ValueError(f"{L} lanes: K1 takes at most {MAX_LANES}")
    base = leaf_table(leaves)
    if base is None:
        return None
    n = sum(leaf.rows * leaf.run for leaf in base)
    if n == 0:
        raise ValueError("no words to hash into lanes")
    width = -(-n // L)
    table = []
    for leaf in base:
        g0, g1 = leaf.base, leaf.base + leaf.rows * leaf.run
        for lane in range(g0 // width, (g1 - 1) // width + 1):
            lo, hi = max(g0, lane * width), min(g1, (lane + 1) * width)
            off = lo - lane * width          # the first word's index in lane
            for piece in _pieces(leaf, lo - g0, hi - g0):
                table.append(piece._replace(lane=lane, base=off))
                off += piece.rows * piece.run
    for lane in range(n // width, L):
        lo = max(n, lane * width) - lane * width
        if lo < width:
            table.append(Leaf(None, ZEROS, 1, width - lo, width - lo, lo,
                              lane=lane))
    if len(table) > MAX_LEAVES:
        return None
    return table


def _leaf_words(leaf: Leaf) -> torch.Tensor:
    """The leaf's words in order, read through the table's own layout (an
    as_strided view), converted as `core.fingerprint._to_u32` converts."""
    t = leaf.tensor
    v = t.as_strided((leaf.rows, leaf.run), (leaf.stride, 1),
                     t.storage_offset() + leaf.offset)
    if leaf.kind == 1:
        v = v.to(torch.float32)          # exact: the bf16 bits << 16
    elif leaf.kind == 2:
        v = v.to(torch.int32)            # the value's low 32 bits
    return v.reshape(-1).view(torch.int32)


def _live_words(leaf: Leaf, device: torch.device) -> torch.Tensor:
    """The leaf's words with those at or past its row limit (and a ring's
    row limit % W) zeroed, the limit compared on its own device (no host
    read)."""
    if leaf.kind == ZEROS:
        return torch.zeros(leaf.run, dtype=torch.int32, device=device)
    words = _leaf_words(leaf)
    if leaf.limit is None:
        return words
    col = torch.arange(leaf.run, device=words.device)
    lim = leaf.limit.to(torch.int64)
    keep = col < lim * leaf.per_row
    if leaf.ring:
        keep = keep & (col // leaf.per_row != lim % leaf.ring)
    return torch.where(keep, words.view(leaf.rows, leaf.run), 0).reshape(-1)


def _table_device(table: Sequence[Leaf]) -> torch.device:
    devs = {t.device for leaf in table
            for t in (leaf.tensor, leaf.limit) if t is not None}
    if len(devs) > 1:
        raise ValueError(
            f"leaves on several devices: {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


def fingerprint_lanes_plain(table: Sequence[Leaf],
                            n_lanes: int) -> torch.Tensor:
    """Plain PyTorch K1 over a (lane) table -> (n_lanes, 4) int32 carrier,
    lane by lane: each lane's hash words and absmax equal
    `fingerprint_plain` of its packed words (with the words past a row
    limit zeroed); the sum is taken row by row."""
    dev = _table_device(table)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fzero = torch.zeros((), dtype=torch.float32, device=dev)
    acc = [[zero, zero, fzero, fzero] for _ in range(n_lanes)]
    for leaf in table:
        p1, p2, ps, pa = _plain_parts(_live_words(leaf, dev), leaf.base)
        h1, h2, s, a = acc[leaf.lane]
        acc[leaf.lane] = [(h1 + p1) & MASK32, (h2 + p2) & MASK32, s + ps,
                          torch.maximum(a, pa)]
    return torch.stack([_carrier(*parts) for parts in acc])


def fingerprint_leaves_plain(table: Sequence[Leaf]) -> torch.Tensor:
    """Plain PyTorch K1 over a leaf table -> (4,) int32 carrier. The hash
    words and absmax equal `fingerprint_plain` of the packed leaves (with
    the words past a row limit zeroed); the sum is taken leaf by leaf."""
    return fingerprint_lanes_plain(table, 1)[0]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("fingerprint").sedar_fingerprint_leaves
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _blocks_for(n: int, n_lanes: int = 1) -> int:
    """Blocks per lane: a function of the word count and the lanes alone, so
    the float reduction tree (and with it the diagnostic `s`) is the same
    on every run; all lanes' blocks fit the MAX_BLOCKS partials."""
    width = -(-n // n_lanes)
    return max(1, min(MAX_BLOCKS // n_lanes, -(-width // (THREADS * 16))))


# (device index, stream) -> (partials, ticket): allocated once, so a call
# allocates nothing but its output; one per stream, so two calls in flight
# on two streams never share a ticket
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int):
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = (
            torch.empty((MAX_BLOCKS, 4), dtype=torch.int32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    return ws


def _empty_result(dev: torch.device, n_lanes: int) -> torch.Tensor:
    """The (n_lanes, 4) output, without deterministic mode's fill of fresh
    memory (a launch of its own): the kernel writes every word."""
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    try:
        return torch.empty((n_lanes, 4), dtype=torch.int32, device=dev)
    finally:
        det.fill_uninitialized_memory = fill


def _limit_rows(table: Sequence[Leaf]):
    """(the kernel's limit rows, each leaf's limit index + 1 or 0): one row
    per distinct (element, dtype, row width, ring)."""
    index: Dict[Tuple[int, torch.dtype, int, int], int] = {}
    rows, refs = [], []
    for leaf in table:
        if leaf.limit is None:
            refs.append(0)
            continue
        key = (leaf.limit.data_ptr(), leaf.limit.dtype, leaf.per_row,
               leaf.ring)
        if key not in index:
            index[key] = len(index) + 1
            rows += [key[0], int(key[1] == torch.int64) | key[3] << 1,
                     key[2]]
        refs.append(index[key])
    return rows, refs


def _launch(table: Sequence[Leaf], dev: torch.device,
            n_lanes: int = 1) -> torch.Tensor:
    limits, refs = _limit_rows(table)
    rows = [v for leaf, ref in zip(table, refs) for v in (
        0 if leaf.tensor is None else
        leaf.tensor.data_ptr() + leaf.offset * leaf.tensor.element_size(),
        leaf.kind, leaf.rows, leaf.run, leaf.stride, leaf.base, ref,
        leaf.lane)]
    n = sum(leaf.rows * leaf.run for leaf in table)
    bpl = _blocks_for(n, n_lanes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials, ticket = _workspace(dev, stream)
        out = _empty_result(dev, n_lanes)
        rc = _launcher()((ctypes.c_longlong * max(1, len(rows)))(*rows),
                         len(table),
                         (ctypes.c_longlong * max(1, len(limits)))(*limits),
                         len(limits) // 3, n_lanes, bpl,
                         partials.data_ptr(), ticket.data_ptr(),
                         out.data_ptr(), stream)
    _build.check(rc, "fingerprint")
    launch_count.add()
    return out


def fingerprint_lanes(table: Sequence[Leaf], n_lanes: int) -> torch.Tensor:
    """K1 wrapper over a lane table (`lane_table`, or a leaf table with
    n_lanes 1) -> (n_lanes, 4) int32 carrier, in one launch."""
    if not 1 <= n_lanes <= MAX_LANES:
        raise ValueError(f"{n_lanes} lanes: K1 takes 1 to {MAX_LANES}")
    dev = _table_device(table)
    if dev.type == "cpu":
        return fingerprint_lanes_plain(table, n_lanes)
    if dev.type != "cuda":
        raise RuntimeError(f"no K1 kernel for device {dev}")
    return _launch(table, dev, n_lanes)


def fingerprint_leaves(table: Sequence[Leaf]) -> torch.Tensor:
    """K1 wrapper over a leaf table (`leaf_table`) -> (4,) int32 carrier:
    the leaves hashed where they lie, in one launch (one lane)."""
    return fingerprint_lanes(table, 1)[0]


def fingerprint_u32(u: torch.Tensor) -> torch.Tensor:
    """K1 wrapper over a packed word buffer (1-D, int32 carrier or
    torch.uint32, contiguous) -> (4,) int32 carrier."""
    if u.dtype == torch.uint32:
        u = u.view(torch.int32)
    if u.dtype != torch.int32 or u.dim() != 1:
        raise TypeError(f"fingerprint_u32 expects a 1-D int32/uint32 word "
                        f"buffer, got {tuple(u.shape)} {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("fingerprint_u32 needs a contiguous buffer")
    if u.device.type == "cpu":
        return fingerprint_plain(u)
    if u.device.type != "cuda":
        raise RuntimeError(f"no K1 kernel for device {u.device}")
    n = u.numel()
    if n >= 2 ** 32:
        raise ValueError(f"{n} words: K1 takes fewer than 2^32")
    return _launch([Leaf(u, 0, 1, n, n, 0)] if n else [], u.device)[0]
