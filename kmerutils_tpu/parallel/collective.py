"""Multi-device counting & sketching via shard_map collectives.

Device re-expression of the reference's parallel inventory
(SURVEY.md §2.10 / /root/reference/src/base/kmercount.rs):

* producer->consumer channels routing kmers to per-thread counters
  (count_kmer_threaded_one_to_many, kmercount.rs:881-974)  ==>  reads are
  data-parallel per device; each device extracts + canonicalizes its reads'
  kmers, computes the invhash shard id (DispatchableT, :382-420), and a
  fixed-capacity ``all_to_all`` exchanges kmers so device d receives exactly
  the kmers with shard id d.  Per-device count tables stay disjoint, like the
  reference's counter pools.
* pool merge of bloom filters (:810-814)  ==>  jax.lax.pmax over slot tensors.
* HLL block merge (setsketchert.rs:863-888)  ==>  jax.lax.pmax of registers.
* rayon par_iter over sequences (every sketcher)  ==>  reads-data-parallel
  shard_map with no communication at all.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..base.sequence import ReadBatch
from ..base import kmer as kmer_mod
from ..count import exact, dispatch
from ..count.exact import SENTINEL64
from ..sketch import setsketch
from .mesh import READS_AXIS

U64 = jnp.uint64


def _bucketize_by_shard(keys, shard_ids, n_shards: int, cap: int):
    """Arrange a device's kmers into [n_shards, cap] send buckets (sentinel
    padded).  Overflowing keys are dropped and counted.

    Sort by shard id (keys ride along), locate shard boundaries with a tiny
    searchsorted, and GATHER each bucket's slots — no scatter/segment-sum.
    Sentinel keys must carry shard id >= n_shards so they sort past every
    real shard.
    """
    ss, sk = jax.lax.sort((jnp.asarray(shard_ids, jnp.int32), keys),
                          num_keys=1, is_stable=True)
    starts = jnp.searchsorted(ss, jnp.arange(n_shards + 1, dtype=jnp.int32))
    counts = starts[1:] - starts[:-1]
    dropped = jnp.maximum(counts - cap, 0).sum()
    r = jnp.arange(cap, dtype=jnp.int32)[None, :]
    idx = jnp.minimum(starts[:-1, None] + r, ss.shape[0] - 1)
    live = r < counts[:, None]
    buckets = jnp.where(live, sk[idx], SENTINEL64)
    return buckets, dropped


def sharded_count(batch: ReadBatch, k: int, mesh: Mesh, shard_cap_factor: float = 1.5):
    """Exact canonical-kmer counting with reads data-parallel and kmer space
    hash-partitioned across the mesh.

    batch arrays must be sharded (or shardable) on the leading axis.  Returns
    per-device-sharded (keys [n_dev, C], counts [n_dev, C], dropped [n_dev])
    where row d holds the distinct kmers whose invhash shard is d.
    """
    n_dev = mesh.shape[READS_AXIS]
    n, Pn = batch.n_reads, max(batch.max_len - k + 1, 1)
    local_slots = (n // n_dev) * Pn
    cap = int(local_slots / n_dev * shard_cap_factor) + 64

    def step(words, lengths):
        local = ReadBatch(words=words, lengths=lengths)
        can, valid, _ = kmer_mod.canonical_kmers(local, k)
        keys = jnp.where(valid, can.astype(U64), SENTINEL64).ravel()
        sid = dispatch.dispatch(
            jnp.where(keys == SENTINEL64, U64(0), keys), n_dev, k)
        # sentinels carry an out-of-range shard id so they sort past every
        # real shard and never consume bucket capacity
        sid = jnp.where(keys == SENTINEL64, n_dev, sid)
        buckets, dropped = _bucketize_by_shard(keys, sid, n_dev, cap)
        # all_to_all: send bucket row j to device j
        recv = jax.lax.all_to_all(buckets[None], READS_AXIS, split_axis=1,
                                  concat_axis=1, tiled=False)[0]
        mine = recv.reshape(-1)  # kmers of my shard from all devices
        kc = exact.count_from_values(mine)
        return (kc.keys[None], kc.counts[None], dropped[None],
                kc.n_distinct[None], kc.n_unique[None])

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(READS_AXIS), P(READS_AXIS)),
                   out_specs=(P(READS_AXIS), P(READS_AXIS), P(READS_AXIS),
                              P(READS_AXIS), P(READS_AXIS)))
    return fn(batch.words, batch.lengths)


def sharded_count_redundant(batch: ReadBatch, k: int, mesh: Mesh):
    """Redundant-compute sharding: every device scans the FULL (replicated)
    batch and keeps only the kmers whose invhash shard is its own — zero
    communication, compute traded for bandwidth.

    Twin of count_kmer_thread_independant (kmercount.rs:797-867), the
    reference's fallback strategy.  Returns per-device-sharded (keys, counts,
    n_distinct, n_unique) like :func:`sharded_count`.
    """
    n_dev = mesh.shape[READS_AXIS]

    def step(words, lengths):
        local = ReadBatch(words=words, lengths=lengths)
        can, valid, _ = kmer_mod.canonical_kmers(local, k)
        keys = jnp.where(valid, can.astype(U64), SENTINEL64).ravel()
        sid = dispatch.dispatch(
            jnp.where(keys == SENTINEL64, U64(0), keys), n_dev, k)
        mine = jax.lax.axis_index(READS_AXIS)
        keys = jnp.where((sid == mine) & (keys != SENTINEL64), keys, SENTINEL64)
        kc = exact.count_from_values(keys)
        return (kc.keys[None], kc.counts[None],
                kc.n_distinct[None], kc.n_unique[None])

    fn = shard_map(step, mesh=mesh, in_specs=(P(), P()),
                   out_specs=(P(READS_AXIS),) * 4)
    return fn(batch.words, batch.lengths)


def sharded_setsketch_collection(items, valid, params, mesh: Mesh, seed: int = 0):
    """One SetSketch for the whole sharded collection: per-device registers
    merged with pmax across the mesh (the device form of the reference's
    block-merge tree, setsketchert.rs:811-895)."""

    def step(it, va):
        regs = setsketch.setsketch_signatures(it, va, params, seed)
        merged = jax.lax.pmax(jnp.max(regs, axis=0), READS_AXIS)
        return merged[None]

    fn = shard_map(step, mesh=mesh, in_specs=(P(READS_AXIS), P(READS_AXIS)),
                   out_specs=P(READS_AXIS))
    out = fn(items, valid)
    return out[0]


def sharded_bloom_insert(slots, keys, nb_hash: int, log2_slots: int, mesh: Mesh):
    """Insert sharded keys into a replicated Bloom slot tensor: local scatter
    then pmax union (kmercount.rs:810-814's mergeability).

    A per-batch capability API, not the per-kmer hot path; exact counting
    streams through count/stream.py + parallel sharded_stream_* instead."""
    from ..count import filters

    def step(sl, ks):
        idx = filters.probe_indices(ks.ravel(), nb_hash, log2_slots)
        mask = (ks.ravel() != SENTINEL64)[:, None]
        val = jnp.where(mask, jnp.uint8(1), jnp.uint8(0))
        val = jnp.broadcast_to(val, idx.shape)  # one value per PROBE
        idx = jnp.where(mask, idx, 0)
        sl = sl.at[idx.ravel()].max(val.ravel())
        return jax.lax.pmax(sl, READS_AXIS)

    fn = shard_map(step, mesh=mesh, in_specs=(P(), P(READS_AXIS)), out_specs=P())
    return fn(slots, keys)


def sharded_stream_create(capacity_per_device: int, mesh: Mesh,
                          wide: bool = False, coords: bool = False):
    """Per-device streaming merge-fold tables, kmer-space sharded — see
    parallel/stream.py (the production multi-chip counting engine)."""
    from . import stream as pstream
    return pstream.sharded_stream_create(capacity_per_device, mesh,
                                         wide, coords)


def sharded_stream_update(table, batch: ReadBatch, k: int, mesh: Mesh,
                          read_num_offset: int = 0,
                          shard_cap_factor: float = 1.5):
    """One exchange+fold step of multi-chip counting through the merge-fold
    tables: reads data-parallel, raw kmer entries (count 1 each, optional
    first-occurrence coords) routed to their invhash shard (all_to_all),
    sorted locally, and folded by ONE merge per device.

    The un-staged single-step API; streaming loops should use
    parallel/stream.ShardedStreamCounter (LSM staging + growth ladder +
    spill).  Returns (updated table, per-device in-transit drop count).
    """
    from . import stream as pstream
    ex = pstream.make_exchange(mesh, k, table.wide, table.coords,
                               shard_cap_factor)
    arrs, live, dropped = ex(batch.words, batch.lengths,
                             jnp.asarray(read_num_offset, jnp.int64))
    fold = pstream.make_fold(mesh, table)
    new_arrs, used, nd, ld, _hint = fold(
        tuple(table.arrs), table.used, table.n_dropped, table.last_distinct,
        tuple(arrs), live)
    import dataclasses
    table = dataclasses.replace(table, arrs=new_arrs, used=used,
                                n_dropped=nd, last_distinct=ld)
    return table, dropped


def sharded_stream_finalize(table, mesh: Mesh, min_count: int = 1,
                            max_count: int | None = None):
    """Single-process host collection of the sharded tables: finalize each
    shard, concatenate, key-sort (the KmerCounterPool union,
    kmercount.rs:546-565).  Multi-process hosts use
    parallel/stream.finalize_local per process instead."""
    from . import stream as pstream
    return pstream.finalize_union(table, min_count, max_count)


def gather_signatures(sigs, mesh: Mesh):
    """All-gather per-device signature blocks so every device (and the host)
    sees the full signature matrix — the collection step before ANN export
    (SURVEY.md §7 step 7)."""
    def step(s):
        return jax.lax.all_gather(s, READS_AXIS, axis=0, tiled=True)

    # all_gather makes every device's output identical; shard_map cannot
    # infer that statically, so replication checking is disabled here
    fn = shard_map(step, mesh=mesh, in_specs=P(READS_AXIS), out_specs=P(),
                   check_vma=False)
    return fn(sigs)


def data_parallel_sketch(sketch_fn, mesh: Mesh):
    """Wrap a per-batch sketch function (items, valid) -> sigs as a
    reads-data-parallel shard_map (the rayon par_iter role — zero comms)."""

    def step(items, valid):
        return sketch_fn(items, valid)

    return shard_map(step, mesh=mesh, in_specs=(P(READS_AXIS), P(READS_AXIS)),
                     out_specs=P(READS_AXIS))
