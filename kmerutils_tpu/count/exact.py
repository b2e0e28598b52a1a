"""Exact k-mer counting via sort + segment reduction.

Capability twin of the reference counting runtime
(/root/reference/src/base/kmercount.rs): KmerCounter (cuckoo + counting-bloom,
:70-288), KmerFilter1 unicity tracking (:985-1123) and the dump drivers.  The
reference's data structures are pointer-chasing filters probed once per kmer —
a shape batched tensor code cannot express.  The device replacement is:

    canonical kmers (+ coords)  →  radix-friendly sort  →  run boundaries
    →  per-run counts (segment reduction)

which yields *exact* counts, the unique/multiple split (count==1 vs >=2), and
unique-kmer coordinates, all as fixed-shape device tensors.  The reference's
counts are approximate by design (bloom fpr 0.03, kmercount.rs:1292: dumps hold
an "approximate count"); exact counting is a strict upgrade that agrees
bit-for-bit wherever the reference's filters did not collide.

Shapes are static: outputs are padded to the input slot count with a
``n_unique`` scalar; invalid / padding slots carry the sentinel key 2^64-1.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..base.sequence import ReadBatch
from ..base import kmer as kmer_mod

U32 = jnp.uint32
U64 = jnp.uint64
SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def sentinel_of(dtype):
    """All-ones padding key for a uint dtype.  Safe for canonical kmer
    values: an all-T kmer is never canonical (its reverse complement is
    all-A = 0), so the max value never occurs as a live key."""
    return np.array(np.iinfo(np.dtype(dtype)).max, np.dtype(dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KmerCounts:
    """Sorted distinct kmers with exact counts (padded, static shape).

    keys:     uint32/uint64[N] (the kmer dtype: 32-bit lanes for k <= 16 —
              flat u32 sorts measure ~1.3x faster than u64) — each distinct
              canonical kmer value appears ONCE, at
              its run-start position in the sorted order; every other slot
              (duplicates, padding) holds sentinel_of(dtype).  Live keys are therefore
              ascending but NOT compacted to the front — compaction would
              cost a 6M-element scatter/gather per batch, and every consumer
              (host dumps, weighted sketching) filters by ``counts > 0``
              anyway.  Use :func:`compact` on host for dense arrays.
    counts:   int32[N]  — multiplicity at run starts, 0 elsewhere.
    n_unique: int32     — number of distinct kmers with count == 1.
    n_distinct: int32   — number of distinct kmers.
    """

    keys: jax.Array
    counts: jax.Array
    n_distinct: jax.Array
    n_unique: jax.Array


def _flatten_valid(kmers, valid):
    flat = jnp.ravel(kmers)          # keep the kmer dtype (u32 for k <= 16)
    v = jnp.ravel(valid)
    return jnp.where(v, flat, sentinel_of(flat.dtype))


def _run_lengths_1d(s, is_real):
    """Run length at every position of a sorted 1-D array via two scans."""
    n = s.shape[0]
    new_run = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]]) & is_real
    idx = jnp.arange(n, dtype=jnp.int32)
    start = jax.lax.cummax(jnp.where(new_run, idx, -1))
    nxt = jnp.where(new_run | ~is_real, idx, n)
    rev_min = jax.lax.cummin(nxt[::-1])[::-1]
    next_start = jnp.concatenate([rev_min[1:], jnp.full((1,), n, jnp.int32)])
    return new_run, next_start - start


def count_from_values(values):
    """Exact counts of a 1-D uint key array (all-ones sentinel = ignore).

    Returns a :class:`KmerCounts` whose arrays have the input length and
    key dtype (run-start-aligned — see the class docstring).
    """
    values = jnp.asarray(values)
    sent = sentinel_of(values.dtype)
    s = jnp.sort(values)
    is_real = s != sent
    new_run, run_len = _run_lengths_1d(s, is_real)
    keys = jnp.where(new_run, s, sent)
    counts = jnp.where(new_run, run_len, 0)
    n_distinct = new_run.sum().astype(jnp.int32)
    n_unique = (new_run & (run_len == 1)).sum().astype(jnp.int32)
    return KmerCounts(keys=keys, counts=counts,
                      n_distinct=n_distinct, n_unique=n_unique)


def count_batch(batch: ReadBatch, k: int) -> KmerCounts:
    """Canonical-kmer exact counting of a read batch — the pipeline behind
    `parsefastq kmer --count` (kmercount.rs:881-974) as one fused jit graph."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    return count_from_values(_flatten_valid(can, valid))


def count_batch_nthash(batch: ReadBatch, k: int) -> KmerCounts:
    """Counting keyed by canonical ntHash values instead of kmer values —
    the 'ntHash generation feeding counting' pipeline (the reference derives
    shard routing and sketch keys from these hashes; counting by hash is
    exact up to u64 hash collisions, ~N^2/2^65 expected)."""
    from ..base import nthash
    _, _, canonical, _, valid = nthash.nthash_kmers(batch, k)
    return count_from_values(_flatten_valid(canonical, valid))


def count_batch_detailed(batch: ReadBatch, k: int, read_num_offset: int = 0):
    """Exact counts plus the FIRST-OCCURRENCE coordinate of every distinct
    canonical kmer (generation order: read-major, position-minor).

    Returns (keys u32/u64[N], counts i32[N], first_read u32[N],
    first_pos u32[N], n_distinct), run-start-aligned like
    :class:`KmerCounts` (live slots are exactly those with counts > 0, in
    ascending key order; padding keys are the dtype's all-ones sentinel).

    The first-occurrence coordinates reproduce the reference's dump ordering
    (its dumps regenerate kmers in scan order and emit each on first sight,
    kmercount.rs:186-224, 1060-1079): the stable sort keeps flat scan order
    within each run, so each run start IS the first occurrence.
    """
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    keys = _flatten_valid(can, valid)
    sent = sentinel_of(keys.dtype)
    n = keys.shape[0]
    P = can.shape[1]
    # variadic stable sort carries the flat index along with the key;
    # (read, pos) fall out of the index arithmetically — no gathers
    idx = jnp.arange(n, dtype=jnp.int32)
    s, perm = jax.lax.sort((keys, idx), num_keys=1, is_stable=True)
    is_real = s != sent
    new_run, run_len = _run_lengths_1d(s, is_real)
    rn = (perm // P).astype(U32) + U32(read_num_offset)
    ps = (perm % P).astype(U32)
    out_keys = jnp.where(new_run, s, sent)
    out_counts = jnp.where(new_run, run_len, 0)
    out_rn = jnp.where(new_run, rn, 0)
    out_ps = jnp.where(new_run, ps, 0)
    n_distinct = new_run.sum().astype(jnp.int32)
    return out_keys, out_counts, out_rn, out_ps, n_distinct


def unique_kmer_coords(batch: ReadBatch, k: int, read_num_offset: int = 0):
    """Unique (count==1) canonical kmers with their coordinates.

    Twin of KmerFilter1 + its coordinate dump (kmercount.rs:985-1123): returns
    (keys u32/u64[N], read_num u32[N], pos u32[N], n_unique), run-start-
    aligned (live slots have key != sentinel, ascending).  The coordinate
    reported for a unique kmer is its single occurrence.
    """
    keys, counts, rn, ps, n_distinct = count_batch_detailed(
        batch, k, read_num_offset)
    is_unique = counts == 1
    out_keys = jnp.where(is_unique, keys, sentinel_of(keys.dtype))
    out_rn = jnp.where(is_unique, rn, 0)
    out_ps = jnp.where(is_unique, ps, 0)
    return out_keys, out_rn, out_ps, is_unique.sum().astype(jnp.int32)


def multiplicity_from_values(values, valid):
    """Within-row multiplicity of every value.

    values [n, P] (any uint), valid bool[n, P] -> int32[n, P] where slot p
    holds the number of occurrences of values[i, p] within row i (0 when
    invalid).  This is the per-row weighted histogram the probminhash
    sketchers consume (setsketchert.rs:128-147), kept in slot-aligned form.
    """
    can = jnp.asarray(values)
    n, P = can.shape
    keys = jnp.where(valid, can, sentinel_of(can.dtype))
    sent = sentinel_of(can.dtype)
    # one variadic sort carries the slot index along with the key (argsort +
    # take_along_axis would re-gather the keys — gathers measure ~10x the
    # sort cost at this size); run lengths in sorted order come from two
    # associative scans (run start via cummax, next-run start via reverse
    # cummin) — no segment-sum
    idx0 = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None, :], (n, P))
    s, order = jax.lax.sort((keys, idx0), dimension=1, num_keys=1)
    is_real = s != sent
    new_run = jnp.concatenate(
        [jnp.ones((n, 1), bool), s[:, 1:] != s[:, :-1]], axis=1) & is_real
    idx = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None, :], (n, P))
    start = jax.lax.cummax(jnp.where(new_run, idx, -1), axis=1)
    nxt = jnp.where(new_run | ~is_real, idx, P)
    rev_min = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
    next_start = jnp.concatenate(
        [rev_min[:, 1:], jnp.full((n, 1), P, jnp.int32)], axis=1)
    run_counts = next_start - start
    # inverse permutation via one variadic re-sort (scatter is ~5x slower)
    _, per_slot = jax.lax.sort((order, run_counts), dimension=1, num_keys=1)
    return jnp.where(valid, per_slot, 0)


def multiplicity_per_slot(batch: ReadBatch, k: int):
    """Per-read multiplicity of the canonical kmer at every position."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    return multiplicity_from_values(can, valid), valid


# ---------------------------------------------------------------------------
# host-side merge across device batches (streaming files larger than HBM)
# ---------------------------------------------------------------------------

def merge_counts_host(parts):
    """Merge KmerCounts from several batches on host.

    parts: iterable of (keys u64 ndarray, counts ndarray) already compacted
    (no sentinel).  Returns (keys, counts) sorted ascending.
    """
    all_keys = np.concatenate([np.asarray(p[0]) for p in parts])
    all_counts = np.concatenate([np.asarray(p[1]) for p in parts])
    order = np.argsort(all_keys, kind="stable")
    ks, cs = all_keys[order], all_counts[order]
    if ks.size == 0:
        return ks, cs
    boundary = np.concatenate([[True], ks[1:] != ks[:-1]])
    out_keys = ks[boundary]
    seg = np.cumsum(boundary) - 1
    out_counts = np.zeros(out_keys.size, dtype=np.int64)
    np.add.at(out_counts, seg, cs)
    return out_keys, out_counts


def merge_detailed_host(parts):
    """Merge (keys, counts, read_nums, positions) tuples from several batches
    on host, fully vectorized: counts sum per key; the coordinate kept is the
    smallest (read, pos) — the global first occurrence.

    Returns (keys, counts, read_nums, positions, first_coord_u64) dense,
    ascending by key; sort records by first_coord_u64 for the reference's
    scan-order dump layout.
    """
    keys = np.concatenate([np.asarray(p[0], dtype=np.uint64) for p in parts])
    counts = np.concatenate([np.asarray(p[1], dtype=np.int64) for p in parts])
    coord = np.concatenate(
        [(np.asarray(p[2], dtype=np.uint64) << np.uint64(32))
         | np.asarray(p[3], dtype=np.uint64) for p in parts])
    if keys.size == 0:
        e = np.zeros(0, np.uint64)
        return e, counts[:0], e.astype(np.uint32), e.astype(np.uint32), e
    order = np.argsort(keys, kind="stable")
    ks, cs, co = keys[order], counts[order], coord[order]
    boundary = np.concatenate([[True], ks[1:] != ks[:-1]])
    starts = np.flatnonzero(boundary)
    out_keys = ks[starts]
    out_counts = np.add.reduceat(cs, starts)
    out_coord = np.minimum.reduceat(co, starts)
    return (out_keys, out_counts,
            (out_coord >> np.uint64(32)).astype(np.uint32),
            (out_coord & np.uint64(0xFFFFFFFF)).astype(np.uint32), out_coord)


def compact(kc: KmerCounts):
    """Strip padding on host; returns numpy (keys, counts) dense ascending."""
    keys = np.asarray(kc.keys)
    counts = np.asarray(kc.counts)
    sel = counts > 0
    return keys[sel], counts[sel]


def compact_detailed(keys, counts, rn, ps):
    """Host densification of count_batch_detailed outputs ->
    numpy (keys, counts, read_nums, positions), ascending by key."""
    counts = np.asarray(counts)
    sel = counts > 0
    return (np.asarray(keys)[sel], counts[sel],
            np.asarray(rn)[sel], np.asarray(ps)[sel])


def compact_unique(keys, rn, ps):
    """Host densification of unique_kmer_coords outputs."""
    keys = np.asarray(keys)
    sel = keys != sentinel_of(keys.dtype)
    return keys[sel], np.asarray(rn)[sel], np.asarray(ps)[sel]
