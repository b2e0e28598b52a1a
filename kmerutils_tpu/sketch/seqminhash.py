"""Range-restricted single-sequence sketches.

Capability twin of /root/reference/src/sketching/seqminhash.rs:19-119:
``sketch_seqrange_superminhash`` / ``sketch_seqrange_minhash`` sketch the
kmers of ONE sequence restricted to a base range [start, end), k dispatched
exactly 16 vs 9..=15, canonical kmers through the invertible hash.

Device form: the range is a validity mask over the kmer start-position axis —
kmer p participates iff start <= p and p + k <= end — applied before the
batched sketch kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..base.sequence import ReadBatch
from ..base import kmer as kmer_mod
from ..ops.rng import wang_hash32
from . import superminhash, minhash


def _range_items(batch: ReadBatch, start: int, end: int, kmer_size: int):
    if not 9 <= kmer_size <= 16 or kmer_size == 15:
        raise ValueError(
            "kmer_size must be 16 or 9..=14 (seqminhash.rs:33-62 dispatch; "
            "15 has no reference kmer type)")
    km, valid = kmer_mod.kmers_u32(batch, kmer_size)
    can, _ = kmer_mod.canonical_u32(km, kmer_size)
    P = km.shape[1]
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = valid & (pos >= start) & (pos + kmer_size <= end)
    return wang_hash32(can), valid


def sketch_seqrange_superminhash(batch: ReadBatch, start: int, end: int,
                                 kmer_size: int, sketch_size: int,
                                 seed: int = 0):
    """SuperMinHash (float signature) of the kmers in [start, end) of every
    read in ``batch`` — [n, sketch_size] float32."""
    items, valid = _range_items(batch, start, end, kmer_size)
    sig, _ = superminhash.superminhash(items.astype(jnp.uint64), valid,
                                       sketch_size, seed)
    return sig


def sketch_seqrange_minhash(batch: ReadBatch, start: int, end: int,
                            kmer_size: int, sketch_size: int):
    """Bottom-``sketch_size`` invertible-minhash with counts of the kmers in
    [start, end) — (hashes u64[n, size] SENTINEL-padded, counts i32[n, size]),
    the HashCount pairs of the reference."""
    items, valid = _range_items(batch, start, end, kmer_size)
    return minhash.bottomk_sketch(items.astype(jnp.uint64), valid, sketch_size)
