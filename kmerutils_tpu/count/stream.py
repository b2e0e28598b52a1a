"""Streaming whole-file counting: merge-fold device table.

This module is the ONLY counting-table engine, built from the plain-XLA
passes of ops/merge.py:

  batch      ->  one flat sort of the batch's canonical kmers (raw entries,
                 count 1 each — no per-batch aggregation pass)
  fold       ->  ONE merge by ranks of (table, batch); duplicate keys
                 coexist as separate entries
  compact    ->  when entries approach capacity: one aggregate pass
                 (ops/merge.aggregate_fold_i32: run heads, cumsum
                 differences, a segmented-min scan)
  finalize   ->  the same pass with the count-range filter, ONE transfer

Between folds the table is a set of int32 arrays of length ``capacity``:
key words sign-flipped (``x ^ 0x80000000``, so signed order is unsigned
order), u32 keys biased +1, and only the prefix [0, used) meaningful —
everything past it is garbage that every consumer masks by ``used``.

The reference counterpart is the cuckoo+counting-bloom insert loop and its
threaded drivers (/root/reference/src/base/kmercount.rs:241-267,881-974);
counts here are exact (saturating at 2^32-1 — far beyond the reference's
8/16-bit dump saturation), and overflow beyond capacity drops the LARGEST
keys deterministically, counted in ``n_dropped`` (entry granularity: a
dropped entry may be a duplicate of a surviving key, so the distinct-key
drop count is <= n_dropped; any surviving largest key may then undercount).

Logical entry layout (table words, ascending by key over [0, used)):
  k <= 16 ("u32 keys"):  (flip(key+1), cnt[, coord_hi, coord_lo])
  k 17..32 ("u64 keys"): (flip(hi(key+1)), flip(lo(key+1)), cnt
                          [, coord_hi, coord_lo])
where flip(x) = x ^ 0x80000000 reinterpreted as i32.  The +1 bias keeps
every live key off the all-ones sentinel that masks the dead tail —
canonical kmer values can be neither 0xFF..FE nor 0xFF..FF (a kmer ending
in C/G/T has a reverse complement strictly below 0xC0.., and one ending in
A is above its own revcomp's first base; either way min(kmer, revcomp) <
0xC0..).  Within a run of equal keys entry order is arbitrary after
merges, so aggregation computes the run coordinate as a segmented MIN, not
the run head.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..base.sequence import ReadBatch
from ..base import kmer as kmer_mod
from ..ops.merge import (merge_fold_i32, aggregate_fold_i32,
                         merge_sorted_u32)

I32 = jnp.int32
U32 = jnp.uint32
U64 = jnp.uint64
I64 = jnp.int64
SENT32 = np.uint32(0xFFFFFFFF)
SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_IMAX = np.int32(0x7FFFFFFF)

# one batch is capped at 8M padded bases (io/fastx.read_batches); the
# auto-compact threshold keeps this much headroom so a fold can never
# overflow between compactions
BATCH_CAP = 9 << 20


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StreamCountTable:
    """Sorted entry table with pending duplicates (see module docstring).

    arrs:      tuple of int32 [capacity] entry words (module docstring
               layout); only the prefix [0, used) is meaningful.
    used:      int32 — occupied entries (live rows incl. duplicates).
    n_dropped: int64 — entries dropped past capacity (largest keys first).
    """

    arrs: tuple
    used: jax.Array
    n_dropped: jax.Array
    # post-compaction occupancy signal for growth policies: set by fold to 1
    # when a compaction just ran AND the fresh DISTINCT count is within
    # 4*BATCH_CAP of capacity.  `used` alone cannot drive growth — it is
    # inflated by pending duplicates between compactions — while this flag
    # is only raised on clean post-compact state, and the 4-batch margin
    # absorbs the host's fetch lag before it reacts (see cli/parsefastq).
    grow_hint: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))
    # distinct count at the last compaction — drives the amortized compact
    # trigger (folds cost O(used), so pending duplicates are bounded at
    # ~2x distinct: compact work stays proportional to what folds already
    # pay, and for duplicate-free streams the trigger backs off
    # exponentially as last_distinct doubles)
    last_distinct: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32))

    # pytree-static config
    wide: bool = dataclasses.field(metadata=dict(static=True), default=False)
    coords: bool = dataclasses.field(metadata=dict(static=True), default=False)
    cap: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def capacity(self) -> int:
        return self.cap

    @staticmethod
    def create(capacity: int, wide: bool, coords: bool) -> "StreamCountTable":
        narr = (3 if wide else 2) + (2 if coords else 0)
        return StreamCountTable(
            arrs=tuple(jnp.full(capacity, _IMAX, I32) for _ in range(narr)),
            used=jnp.zeros((), jnp.int32),
            n_dropped=jnp.zeros((), I64),
            grow_hint=jnp.zeros((), jnp.int32),
            last_distinct=jnp.zeros((), jnp.int32),
            wide=wide, coords=coords, cap=capacity)


def batch_entries(batch: ReadBatch, k: int, read_num_offset,
                  coords: bool = False):
    """One batch's raw sorted entries for :func:`fold`.

    Returns (arrs, n_live): uint32 arrays [n*p] in RAW entry order —
    (key[, cnt, coord_hi, coord_lo]) for u32 keys, split (hi, lo) for u64 —
    sorted ascending, one entry per valid kmer position (count 1 each).
    Keys carry the +1 storage bias at BOTH widths (the table's layout), so
    runs can be merged pairwise with ops/merge.merge_sorted_u32 before
    folding — see :class:`StagedFolder`.  read_num_offset may be a traced
    scalar.
    """
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    n, p = can.shape
    wide = can.dtype == U64
    flatv = jnp.ravel(valid)
    if wide:
        keys = jnp.where(flatv, jnp.ravel(can) + U64(1), SENT64)
    else:
        keys = jnp.where(flatv, jnp.ravel(can) + U32(1), SENT32)
    if coords and not wide:
        # pack (key, position) into one u64 and flat-sort: ~1.2x the plain
        # key sort, vs ~1.6x for a carried-payload variadic sort; the
        # packed order equals the stable (key, idx) order exactly
        idx = jnp.arange(n * p, dtype=U64)
        sp = jnp.sort((keys.astype(U64) << U64(32)) | idx)
        sk = (sp >> U64(32)).astype(U32)
        perm = (sp & U64(0xFFFFFFFF)).astype(jnp.int32)
        live = sk != SENT32
        rn = (perm // p).astype(U32) + jnp.asarray(read_num_offset, U32)
        ps = (perm % p).astype(U32)
        chi = jnp.where(live, rn, SENT32)
        clo = jnp.where(live, ps, SENT32)
    elif coords:
        idx = jnp.arange(n * p, dtype=jnp.int32)
        sk, perm = jax.lax.sort((keys, idx), num_keys=1, is_stable=True)
        live = sk != SENT64
        rn = (perm // p).astype(U32) + jnp.asarray(read_num_offset, U32)
        ps = (perm % p).astype(U32)
        chi = jnp.where(live, rn, SENT32)
        clo = jnp.where(live, ps, SENT32)
    else:
        sk = jnp.sort(keys)
        live = sk != (SENT64 if wide else SENT32)
    cnt = jnp.where(live, U32(1), SENT32)
    if wide:
        arrs = ((sk >> U64(32)).astype(U32), sk.astype(U32), cnt)
    else:
        arrs = (sk.astype(U32), cnt)
    if coords:
        arrs = arrs + (chi, clo)
    return arrs, live.sum().astype(jnp.int32)


def _compact(table: StreamCountTable) -> StreamCountTable:
    # NOTE: never filter by count range here — mid-stream compaction must
    # preserve every run (finalize applies lo/hi on its own aggregate pass)
    outs, n_live = aggregate_fold_i32(
        table.arrs, table.used, kw=2 if table.wide else 1,
        coords=table.coords)
    return dataclasses.replace(table, arrs=tuple(outs), used=n_live,
                               last_distinct=n_live)


def _fold_body(table: StreamCountTable, batch_arrs, batch_live):
    S = table.cap
    ncmp = 2 if table.wide else 1

    def do_fold(t):
        merged = merge_fold_i32(t.arrs, batch_arrs, t.used, ncmp=ncmp)
        used = t.used + batch_live
        dropped = jnp.maximum(used - S, 0).astype(I64)
        return dataclasses.replace(t, arrs=tuple(merged),
                                   used=jnp.minimum(used, S),
                                   n_dropped=t.n_dropped + dropped)

    # F bounds this fold's live entries by the STATIC physical b length
    # (a plain batch is < BATCH_CAP; a StagedFolder run spans up to
    # 2^depth batches).  The capacity headroom derives from it: the hint
    # can only be raised AT a compaction, and the no-drop induction needs
    # S - H + 3F <= S — the last hint-free fold leaves distinct <= S - H,
    # the raising fold adds <= F new distinct plus its own <= F merge, and
    # one host-lag fold adds <= F before the reaction lands (lag-1 hint
    # fetch, cli/parsefastq) — so H = 3F + one batch of margin.
    # StagedFolder caps its depth at 6 * 2^depth * BATCH_CAP <= S so the
    # small-table S//2 clamp never undercuts 3F.
    F = max(batch_arrs[0].shape[0], BATCH_CAP)
    headroom = min(3 * F + BATCH_CAP, S // 2)

    def compact_and_flag(t):
        t = _compact(t)
        # t.used is now the true DISTINCT count; raise the growth hint
        # while the induction above still has its 3-fold slack
        hint = (t.used + batch_live > S - headroom).astype(jnp.int32)
        return dataclasses.replace(t, grow_hint=hint)

    # A second, amortized trigger (independent of the staged fold size)
    # bounds pending duplicates far from capacity.  It was derived for
    # folds that cost O(D + P) HBM traffic (D = distinct, P = pending);
    # the plain-XLA fold's passes span the whole capacity instead, so the
    # trigger's worth is open (ROADMAP D1).  A compaction resets P to 0;
    # balancing total traffic over a
    # fold-compact cycle of P/F folds minimizes at P* = 2*sqrt(D*F)
    # (d/dP of [D + P/2 + 2DF/P] = 0).  The old fixed bound
    # (min(4*BATCH_CAP, S/2)) let P grow ~16x distinct on small-genome
    # coverage streams, nearly doubling every fold's traffic.  When
    # 2*sqrt(D*F) < F the trigger fires every fold — that IS the optimum
    # there (compacting each F-sized fold beats carrying it).  f32 sqrt
    # error at D*F <= 2^56 is ~2^-24 relative — noise against P*.
    d_f32 = jnp.maximum(table.last_distinct, 1).astype(jnp.float32)
    pend_cap = (2.0 * jnp.sqrt(d_f32 * np.float32(F))).astype(jnp.int32)
    need = (table.used + batch_live > S - headroom) | \
        (table.used > table.last_distinct + pend_cap)
    table = jax.lax.cond(need, compact_and_flag,
                         lambda t: dataclasses.replace(
                             t, grow_hint=jnp.zeros((), jnp.int32)), table)
    return do_fold(table)


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("wide", "coords", "cap"))
def _fold_donated(arrs, used, n_dropped, last_distinct, batch_arrs,
                  batch_live, *, wide, coords, cap):
    t = StreamCountTable(arrs=arrs, used=used, n_dropped=n_dropped,
                         last_distinct=last_distinct, wide=wide,
                         coords=coords, cap=cap)
    out = _fold_body(t, batch_arrs, batch_live)
    return out.arrs, out.used, out.n_dropped, out.grow_hint, out.last_distinct


def fold(table: StreamCountTable, batch_arrs, batch_live):
    """Merge one batch's RAW sorted entries into the table (one merge by
    ranks, ops/merge.py); auto-compacts on device when occupancy approaches capacity, so
    a stream of folds never needs host synchronization.

    The table's entry arrays are DONATED, so XLA may reuse the 2-5
    capacity-sized input buffers for the fold's outputs and temporaries
    instead of holding two tables per queued fold (at 2^28 capacity that
    is 1-2 GB per fold).  Do not reuse a table object after
    folding it; StagedFolder/CLI replace their reference every fold.
    Scalar leaves (used/grow_hint/...) are NOT donated — callers may keep
    them (the CLI's lag-1 hint fetches) after the next fold is queued.
    """
    arrs, used, nd, gh, ld = _fold_donated(
        tuple(table.arrs), table.used, table.n_dropped, table.last_distinct,
        batch_arrs, batch_live, wide=table.wide, coords=table.coords,
        cap=table.cap)
    return dataclasses.replace(table, arrs=arrs, used=used, n_dropped=nd,
                               grow_hint=gh, last_distinct=ld)


@jax.jit
def compact(table: StreamCountTable) -> StreamCountTable:
    return _compact(table)


class StagedFolder:
    """LSM-style staging in front of :func:`fold`.

    A fold passes over the whole table, which dominates streaming into a
    large table; merging two batch runs costs O(batch).  Staging merges
    ``2**depth`` consecutive batch runs into ONE sorted run first,
    binary-counter style (each entry passes through ``depth`` O(batch)
    merges), so the table pays its pass once per ``2**depth`` batches.
    Fold order does not affect results: counts are commutative sums and
    run coordinates are segmented minima.

    The reference's analogue is the bounded channel batching kmers in
    front of the shared counter threads
    (/root/reference/src/base/kmercount.rs:881-974).

    ``depth`` defaults by CURRENT table capacity (re-evaluated each push,
    so a host-grown table deepens its staging automatically) such that the
    fold-time drop-safety margins hold (6 * 2**depth * BATCH_CAP <=
    capacity — see :func:`fold`): 0 below 2^27-entry tables, 2 at 2^28
    and above.  Mutate ``.table`` directly for host-driven transitions
    (grow, spill); staged runs carry over unchanged.
    """

    MAX_DEPTH = 2

    def __init__(self, table: StreamCountTable, depth: int | None = None):
        self.table = table
        self._depth = depth
        self._runs: list = []     # [level, arrs, live]; levels strictly
        #                           decreasing bottom-to-top of the stack

    @property
    def depth(self) -> int:
        if self._depth is not None:
            return self._depth
        d = 0
        while (d < self.MAX_DEPTH
               and 6 * (2 << d) * BATCH_CAP <= self.table.cap):
            d += 1
        return d

    def push(self, arrs, live) -> bool:
        """Stage one batch's sorted entries (from :func:`batch_entries`);
        returns True when a table fold was issued (the caller's cue to
        sample ``table.grow_hint``)."""
        self._runs.append([0, tuple(arrs), live])
        while (len(self._runs) >= 2
               and self._runs[-1][0] == self._runs[-2][0]):
            lvl, b, lb = self._runs.pop()
            _, a, la = self._runs.pop()
            m = merge_sorted_u32(a, b, ncmp=2 if self.table.wide else 1)
            self._runs.append([lvl + 1, m, la + lb])
        if self._runs[0][0] >= self.depth:
            _, a, live = self._runs.pop()
            self.table = fold(self.table, a, live)
            return True
        return False

    def flush(self) -> StreamCountTable:
        """Fold any staged remainder (end of stream) and return the table."""
        while self._runs:
            _, a, live = self._runs.pop()
            self.table = fold(self.table, a, live)
        return self.table


def grow(table: StreamCountTable, new_capacity: int) -> StreamCountTable:
    """Grow the table's capacity in place: live entries are a contiguous
    prefix, so growth is ONE sentinel-pad concatenation — no re-sort, no
    merge.  The cuckoo-resize role of the
    reference's capacity bound (kmercount.rs:297-307), but cheap enough to
    run mid-stream: callers start small and grow x8 only when occupancy
    stays high after compaction (see cli/parsefastq)."""
    if new_capacity <= table.cap:
        return table
    pad = new_capacity - table.cap
    return dataclasses.replace(
        table,
        arrs=tuple(jnp.concatenate([a, jnp.full((pad,), _IMAX, I32)])
                   for a in table.arrs),
        cap=new_capacity,
        # occupancy is far from the NEW capacity by construction; a stale
        # raised hint would re-trigger growth/spill immediately
        grow_hint=jnp.zeros((), jnp.int32))


_EXC_CAP = 16384  # fixed exception-list capacity for finalize's delta keys


def _decode_delta_keys(d16, exc_idx, exc_hi, wide: bool, n: int,
                       n_big: int):
    """Reconstruct keys from (u16 gaps, explicit oversized-gap exceptions);
    see finalize.  Exact by construction: every gap >= 2^16 arrives as an
    (index, gap >> 16) pair, so ONE cumsum in the key dtype rebuilds the
    ascending key sequence with no anchors and no patch round trips."""
    W = np.uint64 if wide else np.uint32
    arr = d16.astype(W)
    if n_big:
        idx = exc_idx[:n_big]
        arr[idx] += exc_hi[:n_big].astype(W) << W(16)
    return np.cumsum(arr, dtype=W)


def _q64k(n: int, cap: int) -> int:
    """Quantize a transfer slice length up to the next 64k multiple (capped
    at the array length) so the device slice programs recur across record
    counts instead of compiling per distinct n."""
    return min(cap, -(-max(n, 1) // 65536) * 65536)


@functools.lru_cache(maxsize=None)
def _finalize_prog(kw: int):
    """finalize's device program, cached at MODULE level: a per-call
    `jax.jit` wrapper retraces the aggregate graph on every finalize
    (measured 1.3 s host trace per call); one persistent wrapper per key
    width traces once per (table config, filter statics) and then
    dispatches in ~0 (pytree statics — coords/cap — key jit's own trace
    cache)."""

    @functools.partial(jax.jit, static_argnames=("lo", "hi", "clamp"))
    def run(t, lo, hi, clamp):
        # aggregate + filter + compact (ops/merge.py)
        outs, n = aggregate_fold_i32(t.arrs, t.used, kw=kw, coords=t.coords,
                                     lo=lo, hi=hi)
        if clamp is not None:
            dt = jnp.uint8 if clamp <= 0xFF else jnp.uint16
            cu = jax.lax.bitcast_convert_type(outs[kw], U32)
            cc = jnp.minimum(cu, U32(clamp)).astype(dt)
            outs = outs[:kw] + (cc,) + outs[kw + 1:]
        # un-flip + un-bias the key words ON DEVICE: the dump-ready values
        # ship directly and the host sheds two full-size array passes
        # (measured 3.8 s at 51M records on the CLI box)
        unflip = [jax.lax.bitcast_convert_type(o, U32) ^ U32(0x80000000)
                  for o in outs[:kw]]
        if kw == 2:
            key_out = ((unflip[0].astype(jnp.uint64) << jnp.uint64(32))
                       | unflip[1]) - jnp.uint64(1)
        else:
            key_out = unflip[0] - U32(1)
        # gaps between consecutive live keys (delta[0] = keys[0]); gaps
        # >= 2^16 are rare even at multi-M density (structural holes in
        # the canonical key space: measured 1016 of 2.1M at 190x coverage)
        # but large enough that block-anchor patching shipped whole raw
        # blocks — instead every oversized gap is located ON DEVICE
        # (cumsum of the bad-gap mask + one binary-search per exception
        # slot) and ships as an exact (entry index, gap >> 16) pair in a
        # FIXED-length list, so the host rebuild is one cumsum
        delta = jnp.concatenate([key_out[:1], key_out[1:] - key_out[:-1]])
        # i32 iota: physical lengths stay < 2^31 and the i64 form
        # materialized a 2x-size transient (2.2 GB at 2^28 capacity)
        live = jnp.arange(delta.shape[0], dtype=jnp.int32) < n.astype(I32)
        bad = live & (delta >= delta.dtype.type(1 << 16))
        n_big = jnp.sum(bad.astype(jnp.int64))
        d16 = delta.astype(jnp.uint16)
        bc = jnp.cumsum(bad.astype(jnp.int32))
        r = jnp.arange(1, _EXC_CAP + 1, dtype=jnp.int32)
        pos = jnp.searchsorted(bc, r, side="left").astype(jnp.int64)
        ok = (r - 1) < n_big
        exc_idx = jnp.where(ok, pos, 0).astype(jnp.int32)
        exc_hi = jnp.where(
            ok, jnp.take(delta, pos, mode="clip") >> delta.dtype.type(16),
            delta.dtype.type(0))
        info = jnp.stack([n.astype(jnp.uint64), n_big.astype(jnp.uint64),
                          t.n_dropped.astype(jnp.uint64)])
        return (key_out, d16, exc_idx, exc_hi) + outs[kw:], info

    return run


def finalize(table: StreamCountTable, min_count: int = 1,
             max_count: int | None = None, count_clamp: int | None = None,
             phases: dict | None = None):
    """Aggregate + compact + filter on device, then ONE host transfer.

    Returns numpy (keys u32/u64 UNBIASED, counts, read_nums u32,
    positions u32) ascending by key (read_nums/positions all-zero when the
    table tracks no coordinates).  ``count_clamp`` saturates counts on
    DEVICE to 0xFF/0xFFFF and transfers them at 1/2 bytes each — the dump
    formats saturate anyway (kmercount.rs counter_size), and the
    device->host link is the finalize bottleneck.

    Keys ride the link DELTA-ENCODED when the encoding pays: they are
    ascending and unique, so at multi-M density almost every gap is tiny
    (mean 84 at 51M records over u32) — BUT the canonical key space has
    structural holes (measured gaps up to ~343k even at 51M records, and
    1016 gaps >= 2^16 at 2.1M records), so a global "fits u16" test never
    fires and block-anchor patching shipped whole raw blocks (round 4:
    ~half the blocks bad on dense coverage tables, disabling the
    encoding).  Instead the device ships mod-2^16 gaps plus an EXACT,
    fixed-length exception list — (entry index, gap >> 16) for every
    oversized gap, located on device — and the host rebuild is one
    cumsum.  Tables with more than ``_EXC_CAP`` oversized gaps (very
    sparse key sets, where gaps are mostly large anyway) fall back to raw
    keys; the decision count rides the same small fetch as ``n``.
    """
    import time as _time
    kw = 2 if table.wide else 1
    run = _finalize_prog(kw)
    t0 = _time.perf_counter()
    outs, info_dev = run(table, min_count, max_count, count_clamp)
    info = np.asarray(info_dev)     # device aggregate + one tiny fetch
    t1 = _time.perf_counter()
    n, n_big, dropped = int(info[0]), int(info[1]), int(info[2])
    if phases is not None:
        phases["agg_s"] = phases.get("agg_s", 0.0) + (t1 - t0)
        phases["records"] = phases.get("records", 0) + n
    if n == 0:
        # empty/fully-filtered table: skip the device slices entirely —
        # _q64k's max(n, 1) would otherwise queue a full 64k-row transfer
        # of garbage per array
        z = np.zeros(0, np.uint32)
        keys = z.astype(np.uint64) if table.wide else z
        cdt = (np.uint32 if count_clamp is None
               else np.uint8 if count_clamp <= 0xFF else np.uint16)
        return keys, np.zeros(0, cdt), z, z, int(dropped)
    # delta pays its fixed exception-list cost whenever the u16 gaps are
    # representable; past _EXC_CAP oversized gaps the key set is sparse
    # enough that raw keys are the honest encoding
    delta_mode = n_big <= _EXC_CAP and n >= (1 << 16)
    # slice lengths QUANTIZED up to 64k multiples: `o[:n]` with a raw n
    # compiles one slice program per distinct record count (measured ~1 s
    # of compile on a fresh n); rung-quantized lengths recur across files
    # at <= 64k extra rows (~0.3 MB) of link traffic.  Hosts trim to n.
    # The exception arrays are fixed-length (_EXC_CAP) — no rungs at all.
    nq = _q64k(n, outs[0].shape[0])
    key_slices = ([outs[1][:nq], outs[2], outs[3]] if delta_mode
                  else [outs[0][:nq]])
    rest = [o[:nq] for o in outs[4:]]
    for s in key_slices + rest:
        # queue EVERY transfer up front: the link is the bottleneck, and
        # the host-side key decode below rides under the counts/coords
        # transfers instead of serializing after them
        s.copy_to_host_async()
    if delta_mode:
        keys = _decode_delta_keys(np.asarray(key_slices[0])[:n],
                                  np.asarray(key_slices[1]),
                                  np.asarray(key_slices[2]),
                                  table.wide, n, n_big)
    else:
        keys = np.asarray(key_slices[0])[:n]
    host = [np.asarray(o)[:n] for o in rest]
    if phases is not None:
        phases["xfer_s"] = phases.get("xfer_s", 0.0) \
            + (_time.perf_counter() - t1)
    host.insert(0, keys)  # keep positional layout below
    counts = host[1] if count_clamp is not None else host[1].view(np.uint32)
    if table.coords:
        rn = host[2].view(np.uint32)
        ps = host[3].view(np.uint32)
    else:
        rn = np.zeros(n, np.uint32)
        ps = np.zeros(n, np.uint32)
    return keys, counts, rn, ps, int(dropped)
