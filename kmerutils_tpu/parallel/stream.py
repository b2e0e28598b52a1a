"""Multi-chip streaming counting: the production sharded merge-fold path.

One engine, two scales: count/stream.py owns the single-device streaming
table (merge-fold, LSM staging, growth ladder, disk spill); this module
runs the SAME machinery per device with kmer space hash-partitioned across
a jax mesh:

  exchange  ->  reads data-parallel; each device extracts + canonicalizes
                its reads' kmers, routes them by invhash shard id
                (DispatchableT, /root/reference/src/base/kmercount.rs:
                382-420) through ONE bucketized all_to_all, and sorts the
                received keys into a fold-ready run (count 1 each,
                +1-biased keys — count/stream.py's layout contract).
  stage     ->  per-device LSM staging: 2**depth consecutive runs merge
                binary-counter style (ops/merge.merge_sorted_u32
                under shard_map) before touching the table, so the
                O(occupancy) table re-read amortizes — the same bounded
                channel role as the reference's producer->consumer pipe
                (kmercount.rs:881-974).
  fold      ->  ONE merge fold per device (stream._fold_body inside
                shard_map, buffers donated, NO collective — per-host fold
                pipelines stay independent).  The device-raised per-shard
                grow hints are pmax-reduced by a separate tiny program
                (make_hint_reduce) at the host's lag-1 sample points, so
                every host process reads the same ladder signal.
  grow      ->  all shards grow together (capacity is static per table) —
                the cuckoo-resize role of kmercount.rs:297-307.
  spill     ->  when the ladder tops out, each host process ships ITS
                addressable shards to per-shard disk segments
                (count/spill.py) and restarts them empty — exact at any
                cardinality, like the single-chip CLI.
  finalize  ->  per-shard aggregate+filter on device; the shard union is a
                concatenation + key sort (the KmerCounterPool union,
                kmercount.rs:546-565).  Multi-process hosts finalize their
                own shards (finalize_local); the full union requires a
                single process.

The reference's counter pool is thread-sharded inside one box; this is the
same partition across devices with device-resident tables.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..base.sequence import ReadBatch
from ..base import kmer as kmer_mod
from ..count import dispatch, stream
from ..count.exact import SENTINEL64
from ..ops.merge import merge_sorted_u32
from .mesh import READS_AXIS

# Module-level program cache shared by every ShardedStreamCounter (and the
# one-shot collective.py drivers): the jitted exchange/merge/fold programs
# are pure functions of (mesh, static params), so two counter instances
# with the same mesh MUST share executables.  Without this, every fresh
# instance re-traced and re-compiled the whole program family — measured
# 29 s of duplicated compile CPU inside a 2-process CPU-mesh run whose
# actual steady-state work is ~3.5 s/batch.
_PROG_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)



I32 = jnp.int32
U32 = jnp.uint32
U64 = jnp.uint64
_IMAX = np.int32(0x7FFFFFFF)
_add = jax.jit(jnp.add)


def _shard_map(fn, mesh, in_specs, out_specs):
    """shard_map with replication checking off: the per-shard programs mix
    device-varying and replicated values freely."""
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def sharded_stream_create(capacity_per_device: int, mesh: Mesh,
                          wide: bool = False, coords: bool = False):
    """Per-device streaming merge-fold tables (count/stream.py), kmer-space
    sharded: a StreamCountTable pytree with leading axis n_devices, sharded
    over the mesh.  Device d's table only ever holds kmers whose invhash
    shard is d (disjoint, like the reference's counter pool)."""
    n_dev = mesh.shape[READS_AXIS]
    table = stream.StreamCountTable.create(capacity_per_device, wide, coords)
    stacked = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_dev,) + x.shape), table)
    sh = NamedSharding(mesh, P(READS_AXIS))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), stacked)


def _multi_bucketize(payloads, shard_ids, n_shards: int, cap: int,
                     sentinels):
    """[n] payload arrays -> [n_shards, cap] send buckets sharing ONE
    variadic sort by shard id; overflow past cap is dropped and counted."""
    ops = (jnp.asarray(shard_ids, jnp.int32),) + tuple(payloads)
    sorted_ops = jax.lax.sort(ops, num_keys=1, is_stable=True)
    ss = sorted_ops[0]
    starts = jnp.searchsorted(ss, jnp.arange(n_shards + 1, dtype=jnp.int32))
    counts = starts[1:] - starts[:-1]
    dropped = jnp.maximum(counts - cap, 0).sum()
    r = jnp.arange(cap, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(starts[:-1, None] + r, ss.shape[0] - 1)
    live = r < counts[:, None]
    buckets = tuple(jnp.where(live, sp[idx], sent)
                    for sp, sent in zip(sorted_ops[1:], sentinels))
    return buckets, dropped


def make_exchange(mesh: Mesh, k: int, wide: bool, coords: bool,
                  shard_cap_factor: float = 1.5):
    """Build (or fetch from _PROG_CACHE) the jitted exchange step for one
    batch SHAPE family.

    Returns fn(words, lengths, read_num_offset) -> (run_arrs, live, dropped)
    where run_arrs is a tuple of [n_dev, L] uint32 arrays in count/stream.py
    RAW entry order (biased keys ascending, count 1 each, optional coords),
    live [n_dev] int32, dropped [n_dev] int64-ish in-transit drops.
    read_num_offset is traced, so one compile serves the whole stream.
    """
    ckey = ("exchange", _mesh_key(mesh), k, wide, coords, shard_cap_factor)
    if ckey in _PROG_CACHE:
        return _PROG_CACHE[ckey]
    n_dev = mesh.shape[READS_AXIS]
    SENT32 = np.uint32(0xFFFFFFFF)

    def step(words, lengths, offset):
        local = ReadBatch(words=words, lengths=lengths)
        can, valid, _ = kmer_mod.canonical_kmers(local, k)
        dev = jax.lax.axis_index(READS_AXIS)
        n_local, p = can.shape
        cap = int(n_local * p / n_dev * shard_cap_factor) + 64
        keys = jnp.where(valid.ravel(), can.ravel().astype(U64), SENTINEL64)
        live = keys != SENTINEL64
        sid = dispatch.dispatch(jnp.where(live, keys, U64(0)), n_dev, k)
        sid = jnp.where(live, sid, n_dev)
        payloads = [keys]
        sentinels = [SENTINEL64]
        if coords:
            idx = jnp.arange(n_local * p, dtype=jnp.int64)
            rn = (idx // p + offset
                  + dev.astype(jnp.int64) * n_local).astype(U64)
            coord = (rn << U64(32)) | (idx % p).astype(U64)
            payloads.append(jnp.where(live, coord, SENTINEL64))
            sentinels.append(SENTINEL64)
        buckets, dropped = _multi_bucketize(payloads, sid, n_dev, cap,
                                            sentinels)
        recv = [jax.lax.all_to_all(b[None], READS_AXIS, 1, 1,
                                   tiled=False)[0].reshape(-1)
                for b in buckets]
        mine_k = recv[0]
        if coords:
            sk, so = jax.lax.sort((mine_k, recv[1]), num_keys=1)
        else:
            sk = jnp.sort(mine_k)
        is_live = sk != SENTINEL64
        if wide:
            biased = jnp.where(is_live, sk + U64(1), SENTINEL64)
            arrs = ((biased >> U64(32)).astype(U32), biased.astype(U32))
        else:
            # +1 storage bias; live canonical values <= 0xFF..FD so no wrap
            arrs = (jnp.where(is_live, sk.astype(U32) + U32(1), SENT32),)
        arrs = arrs + (jnp.where(is_live, U32(1), SENT32),)
        if coords:
            arrs = arrs + (
                jnp.where(is_live, (so >> U64(32)).astype(U32), SENT32),
                jnp.where(is_live, so.astype(U32), SENT32))
        return (tuple(a[None] for a in arrs),
                is_live.sum().astype(I32)[None],
                dropped.astype(jnp.int64)[None])

    fn = _shard_map(step, mesh,
                    in_specs=(P(READS_AXIS), P(READS_AXIS), P()),
                    out_specs=(P(READS_AXIS), P(READS_AXIS), P(READS_AXIS)))
    prog = _PROG_CACHE[ckey] = jax.jit(fn)
    return prog


def make_fold(mesh: Mesh, table_like: stream.StreamCountTable):
    """Build the jitted + donated sharded fold for one (table, run-length)
    shape family: fn(arrs, used, n_dropped, last_distinct, run_arrs, live)
    -> (arrs, used, n_dropped, last_distinct, hint) with hint the PER-SHARD
    int32 grow_hint vector [n_dev].  Deliberately NO collective here: a
    fold with an in-program pmax is a cross-process rendezvous per fold,
    which serializes per-host fold pipelines (and, measured on the 1-core
    CPU harness, burns the early process's entire wait as spin — fold CPU
    1.4 s -> 6.4 s at 2 processes).  The ladder instead reduces sampled
    hints through make_hint_reduce at the host's existing lag-1 sample
    point, so folds on different hosts proceed independently."""
    wide, coords, cap = table_like.wide, table_like.coords, table_like.cap
    ckey = ("fold", _mesh_key(mesh), wide, coords, cap)
    if ckey in _PROG_CACHE:
        return _PROG_CACHE[ckey]

    def step(arrs, used, n_dropped, last_distinct, run_arrs, live):
        t = stream.StreamCountTable(
            arrs=tuple(a[0] for a in arrs), used=used[0],
            n_dropped=n_dropped[0], last_distinct=last_distinct[0],
            wide=wide, coords=coords, cap=cap)
        out = stream._fold_body(t, tuple(r[0] for r in run_arrs), live[0])
        return (tuple(a[None] for a in out.arrs), out.used[None],
                out.n_dropped[None], out.last_distinct[None],
                out.grow_hint.astype(I32)[None])

    fn = _shard_map(step, mesh,
                    in_specs=(P(READS_AXIS),) * 6,
                    out_specs=(P(READS_AXIS),) * 5)
    prog = _PROG_CACHE[ckey] = jax.jit(fn, donate_argnums=(0,))
    return prog


def make_drop_reduce(mesh: Mesh):
    """Replicated psum of the per-device in-transit drop accumulators
    (all_to_all bucket overflow is counted on the SENDER side, so the
    global number needs one reduction).  A collective: in multi-process
    use every process must launch it at the same point."""
    ckey = ("drop_reduce", _mesh_key(mesh))
    if ckey in _PROG_CACHE:
        return _PROG_CACHE[ckey]

    def step(d):
        return jax.lax.psum(d[0], READS_AXIS)

    fn = _shard_map(step, mesh, in_specs=(P(READS_AXIS),), out_specs=P())
    prog = _PROG_CACHE[ckey] = jax.jit(fn)
    return prog


def make_hint_reduce(mesh: Mesh):
    """Tiny replicated pmax of the per-shard grow hints — the ONLY
    cross-process agreement in the growth ladder, launched at the host's
    sparse sample points (not inside the fold)."""
    ckey = ("hint_reduce", _mesh_key(mesh))
    if ckey in _PROG_CACHE:
        return _PROG_CACHE[ckey]

    def step(h):
        return jax.lax.pmax(h[0], READS_AXIS).astype(I32)

    fn = _shard_map(step, mesh, in_specs=(P(READS_AXIS),), out_specs=P())
    prog = _PROG_CACHE[ckey] = jax.jit(fn)
    return prog


def make_merge_runs(mesh: Mesh, wide: bool, narr: int):
    """Build the jitted per-device staged-run merge (one
    ops/merge.merge_sorted_u32 per shard under shard_map)."""
    ckey = ("merge_runs", _mesh_key(mesh), wide, narr)
    if ckey in _PROG_CACHE:
        return _PROG_CACHE[ckey]
    ncmp = 2 if wide else 1

    def step(a_arrs, b_arrs):
        m = merge_sorted_u32(tuple(x[0] for x in a_arrs),
                             tuple(x[0] for x in b_arrs), ncmp=ncmp)
        return tuple(x[None] for x in m)

    fn = _shard_map(step, mesh, in_specs=(P(READS_AXIS), P(READS_AXIS)),
                    out_specs=P(READS_AXIS))
    prog = _PROG_CACHE[ckey] = jax.jit(fn)
    return prog


def sharded_grow(table, new_capacity: int, mesh: Mesh):
    """Grow every shard's capacity together: live entries are contiguous
    prefixes, so growth is one sentinel-pad concat per leaf (stream.grow
    per shard, stacked).  Stale grow hints are cleared like stream.grow."""
    if new_capacity <= table.cap:
        return table
    pad = new_capacity - table.cap
    sh = NamedSharding(mesh, P(READS_AXIS))

    # no donation: the padded output is a different shape, so the input
    # can never alias it (the old buffer frees as soon as the concat runs)
    @functools.partial(jax.jit, out_shardings=sh)
    def pad_leaf(x):
        return jnp.concatenate(
            [x, jnp.full((x.shape[0], pad), _IMAX, I32)], axis=1)

    return dataclasses.replace(
        table,
        arrs=tuple(pad_leaf(a) for a in table.arrs),
        cap=new_capacity,
        grow_hint=jnp.zeros_like(table.grow_hint))


def local_shard_tables(table):
    """Yield (global shard row, single-device StreamCountTable) for every
    shard addressable by THIS process — the per-host view of the pool.
    Works single- and multi-process (each process sees only its rows)."""
    leaves = {"used": table.used, "n_dropped": table.n_dropped,
              "grow_hint": table.grow_hint,
              "last_distinct": table.last_distinct}
    for j, a in enumerate(table.arrs):
        leaves[f"arr{j}"] = a
    rows: dict[int, dict] = {}
    for name, leaf in leaves.items():
        for s in leaf.addressable_shards:
            r = s.index[0].start or 0
            rows.setdefault(r, {})[name] = s.data[0]
    for r in sorted(rows):
        d = rows[r]
        yield r, stream.StreamCountTable(
            arrs=tuple(d[f"arr{j}"] for j in range(len(table.arrs))),
            used=d["used"], n_dropped=d["n_dropped"],
            grow_hint=d["grow_hint"], last_distinct=d["last_distinct"],
            wide=table.wide, coords=table.coords, cap=table.cap)


def finalize_local(table, min_count: int = 1, max_count: int | None = None,
                   count_clamp: int | None = None):
    """Finalize THIS process's shards: {shard row: (keys, counts, read_nums,
    positions, dropped)} with keys UNBIASED ascending within each shard."""
    return {r: stream.finalize(t, min_count, max_count, count_clamp)
            for r, t in local_shard_tables(table)}


def finalize_union(table, min_count: int = 1, max_count: int | None = None,
                   count_clamp: int | None = None):
    """Single-process union of every shard: concatenate + key sort (the
    KmerCounterPool union, kmercount.rs:546-565)."""
    if jax.process_count() > 1:
        raise RuntimeError("finalize_union needs all shards addressable; "
                           "use finalize_local per process")
    parts = list(finalize_local(table, min_count, max_count,
                                count_clamp).values())
    keys = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    rn = np.concatenate([p[2] for p in parts])
    ps = np.concatenate([p[3] for p in parts])
    dropped = sum(p[4] for p in parts)
    order = np.argsort(keys, kind="stable")
    return keys[order], counts[order], rn[order], ps[order], dropped


class ShardedStreamCounter:
    """The multi-chip `parsefastq --count` engine: hash-sharded per-device
    merge-fold tables with LSM staging, a growth ladder, and disk spill —
    count/stream.py's single-chip feature set at pod scale.

    update() routes one reads-sharded batch (ONE all_to_all), stages the
    received per-device runs, and folds every 2**depth batches; the folds
    emit PER-SHARD grow hints (no in-fold collective — per-host fold
    pipelines stay independent) which the host reduces to one replicated
    scalar (make_hint_reduce) with LAG 1 (the device runs fold i while the
    host reads fold i-1's hint — stream.fold's headroom covers the lag;
    see ``hint_every`` to sample sparser on pre-sized streams).  Growth multiplies every shard's capacity x8 toward
    ``cap_max_per_device``; past the ladder, each host process spills its
    addressable shards to per-shard disk segments and the tables restart
    empty (exact at any cardinality, count/spill.py).

    Reference roles: KmerCounterPool + DispatchableT sharding
    (kmercount.rs:382-565), the bounded producer channel (:881-974), the
    cuckoo capacity bound (:297-307).
    """

    MAX_DEPTH = 2

    def __init__(self, mesh: Mesh, capacity_per_device: int, *,
                 wide: bool = False, coords: bool = False,
                 cap_max_per_device: int | None = None,
                 depth: int | None = None, spill: bool = True,
                 spill_dir: str | None = None,
                 shard_cap_factor: float = 1.5,
                 hint_every: int = 1):
        self.mesh = mesh
        self.n_dev = mesh.shape[READS_AXIS]
        self.wide, self.coords = wide, coords
        self.table = sharded_stream_create(capacity_per_device, mesh,
                                           wide, coords)
        self.cap_max = cap_max_per_device or capacity_per_device
        self._depth = depth
        self._spill_ok = spill
        self._spill_dir = spill_dir
        self.spill_stores: dict | None = None   # shard row -> SpillStore
        self._runs: list = []       # [level, stacked arrs, live [n_dev]]
        self._pending: list = []    # queued replicated grow-hint scalars
        self._exchange = {}         # (shape, k) -> jitted exchange
        self._fold = {}             # run physical length -> jitted fold
        self._merge = {}            # narr -> jitted staged merge
        self._hint_prog = None      # lazily built make_hint_reduce
        self._shard_cap_factor = shard_cap_factor
        # growth-hint sample interval (folds).  1 = lag-1 (default, the
        # tightest the fold's headroom needs); a stream whose capacity is
        # pre-sized (no growth expected) can raise it to amortize the
        # hint-reduce rendezvous — the only cross-process sync besides the
        # per-batch exchange — over many folds.
        self.hint_every = max(1, hint_every)
        self._fold_i = 0
        self.dropped_in_transit = 0

    @property
    def depth(self) -> int:
        if self._depth is not None:
            return self._depth
        d = 0
        while (d < self.MAX_DEPTH
               and 6 * (2 << d) * stream.BATCH_CAP <= self.table.cap):
            d += 1
        return d

    # -- jit caches -------------------------------------------------------
    def _get_exchange(self, batch: ReadBatch, k: int):
        key = (batch.words.shape, k)
        if key not in self._exchange:
            self._exchange[key] = make_exchange(
                self.mesh, k, self.wide, self.coords,
                self._shard_cap_factor)
        return self._exchange[key]

    def _get_fold(self, run_len: int):
        key = (run_len, self.table.cap)
        if key not in self._fold:
            self._fold[key] = make_fold(self.mesh, self.table)
        return self._fold[key]

    def _get_merge(self, narr: int):
        if narr not in self._merge:
            self._merge[narr] = make_merge_runs(self.mesh, self.wide, narr)
        return self._merge[narr]

    def _hint_reduce(self, h):
        if self._hint_prog is None:
            self._hint_prog = make_hint_reduce(self.mesh)
        return self._hint_prog(h)

    # -- streaming --------------------------------------------------------
    def update(self, batch: ReadBatch, k: int, read_num_offset: int = 0
               ) -> None:
        """Route + stage one reads-sharded batch; folds/ladder run as
        staging dictates.  batch arrays must be sharded (or shardable) on
        the leading axis over the mesh."""
        arrs, live, dropped = self._get_exchange(batch, k)(
            batch.words, batch.lengths,
            jnp.asarray(read_num_offset, jnp.int64))
        self._dropped_push(dropped)
        self._push(arrs, live)

    def _dropped_push(self, dropped):
        # in-transit drops are all-zero in any correctly-capacity'd run;
        # keep ONE device-side accumulator, fetched at finalize
        if isinstance(self.dropped_in_transit, int):
            self.dropped_in_transit = dropped
        else:
            self.dropped_in_transit = _add(self.dropped_in_transit, dropped)

    def _push(self, arrs, live):
        self._runs.append([0, tuple(arrs), live])
        while (len(self._runs) >= 2
               and self._runs[-1][0] == self._runs[-2][0]):
            lvl, b, lb = self._runs.pop()
            _, a, la = self._runs.pop()
            m = self._get_merge(len(a))(a, b)
            self._runs.append([lvl + 1, m, la + lb])
        if self._runs[0][0] >= self.depth:
            _, a, live = self._runs.pop(0)
            self._fold_run(a, live)

    def _fold_run(self, arrs, live):
        t = self.table
        fold = self._get_fold(arrs[0].shape[1])
        new_arrs, used, nd, ld, hint = fold(
            tuple(t.arrs), t.used, t.n_dropped, t.last_distinct,
            tuple(arrs), live)
        self.table = dataclasses.replace(
            t, arrs=new_arrs, used=used, n_dropped=nd, last_distinct=ld)
        self._pending.append(hint)
        self._fold_i += 1
        if len(self._pending) > 1 and self._fold_i % self.hint_every == 0:
            # reduce the lagged per-shard hints to one replicated scalar
            # (identical on every process => identical ladder decisions;
            # _fold_i is lockstep across processes, so every process
            # launches the reduce at the same fold indices)
            h = int(np.asarray(self._hint_reduce(self._pending.pop(0))))
            self._pending = self._pending[-1:]
            if h:
                self._ladder()

    def _ladder(self):
        if self.table.cap < self.cap_max:
            new_cap = min(self.table.cap * 8, self.cap_max)
            self.table = sharded_grow(self.table, new_cap, self.mesh)
            self._fold.clear()          # capacity changed -> new programs
            self._pending.clear()       # stale hints from the old capacity
        elif self._spill_ok:
            self.spill_shards()
            self._pending.clear()

    def spill_shards(self):
        """Ship every addressable shard's aggregated runs to its disk
        segment store and restart the sharded tables empty."""
        from ..count import spill as spill_mod
        if self.spill_stores is None:
            self.spill_stores = {}
        for r, t in local_shard_tables(self.table):
            keys, counts, rn, ps, dropped = stream.finalize(t, min_count=1)
            store = self.spill_stores.get(r)
            if store is None:
                store = spill_mod.SpillStore(wide=self.wide,
                                             coords=self.coords,
                                             tmpdir=self._spill_dir)
                self.spill_stores[r] = store
            store.n_dropped += dropped
            store.add_segment(keys, counts,
                              rn if self.coords else None,
                              ps if self.coords else None)
        self.table = sharded_stream_create(self.table.cap, self.mesh,
                                           self.wide, self.coords)

    def flush(self):
        """Fold any staged remainder (end of stream); returns the table."""
        while self._runs:
            _, a, live = self._runs.pop(0)
            self._fold_run(a, live)
        self._pending.clear()
        return self.table

    # -- collection -------------------------------------------------------
    def reduce_in_transit_drops(self) -> int:
        """Reduce the per-device in-transit drop accumulators (all_to_all
        bucket overflow, sender-side) to ONE global count, cached as an int
        in ``dropped_in_transit``.  Works single- and multi-process (psum
        over the mesh, replicated result — every process reads the same
        total).  A collective in multi-process use: all processes must
        call it at the same point; finalize_local does."""
        if not isinstance(self.dropped_in_transit, int):
            prog = make_drop_reduce(self.mesh)
            self.dropped_in_transit = int(
                np.asarray(prog(self.dropped_in_transit)))
        return self.dropped_in_transit

    def finalize_local(self, min_count: int = 1,
                       max_count: int | None = None,
                       count_clamp: int | None = None):
        """Per-process shard results after flush(): {shard row: (keys,
        counts, read_nums, positions, dropped)}.  When spill epochs
        happened, each shard's segments (+ its final table) are k-way
        merged with the count-range filter applied post-merge.

        Also reduces the in-transit drop accumulator into
        ``dropped_in_transit`` (a global int, identical on every process)
        — a mis-sized ``shard_cap_factor`` run surfaces its exchange
        overflow here instead of silently under-reporting (the per-shard
        ``dropped`` in the result tuples counts TABLE drops only)."""
        self.flush()
        self.reduce_in_transit_drops()
        if self.spill_stores:
            self.spill_shards()          # final tables join their segments
            out = {}
            hi = max_count if max_count is not None else np.uint64(1 << 63)
            for r, store in sorted(self.spill_stores.items()):
                pk, pc, pr, pp = [], [], [], []
                for mk, mc, mr, mp in store.merge_stream():
                    sel = (mc >= min_count) & (mc <= hi)
                    pk.append(mk[sel])
                    if count_clamp is not None:
                        dt = np.uint8 if count_clamp <= 0xFF else np.uint16
                        pc.append(np.minimum(mc[sel], count_clamp)
                                  .astype(dt))
                    else:
                        pc.append(mc[sel])
                    pr.append(mr[sel])
                    pp.append(mp[sel])
                cat = lambda xs: (np.concatenate(xs) if xs
                                  else np.zeros(0, np.uint32))
                out[r] = (cat(pk), cat(pc), cat(pr), cat(pp),
                          store.n_dropped)
            return out
        return finalize_local(self.table, min_count, max_count, count_clamp)

    def finalize(self, min_count: int = 1, max_count: int | None = None,
                 count_clamp: int | None = None):
        """Single-process whole-pool union (keys ascending).  Also fetches
        the in-transit drop accumulator into ``dropped_in_transit``."""
        if jax.process_count() > 1:
            # guard BEFORE finalize_local: it folds and can spill — wasted
            # work and side effects on the error path otherwise
            raise RuntimeError("finalize needs all shards addressable; "
                               "use finalize_local per process")
        parts = list(self.finalize_local(min_count, max_count,
                                         count_clamp).values())
        keys = np.concatenate([p[0] for p in parts])
        counts = np.concatenate([p[1] for p in parts])
        rn = np.concatenate([p[2] for p in parts])
        ps = np.concatenate([p[3] for p in parts])
        dropped = sum(int(p[4]) for p in parts)
        order = np.argsort(keys, kind="stable")
        return keys[order], counts[order], rn[order], ps[order], dropped

    def close(self):
        if self.spill_stores:
            for store in self.spill_stores.values():
                store.close()
            self.spill_stores = None
