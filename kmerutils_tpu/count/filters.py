"""Probabilistic membership / counting filters as device tensors.

Capability twins of the reference's CuckooFilter + CountingBloomFilter pair
(/root/reference/src/base/kmercount.rs:70-123) for the memory-bounded
streaming regime.  On the device a filter is a flat tensor updated with
scatter ops:

* :class:`BloomFilter`   — uint8 slot array; insert = scatter-max(1), query =
  AND over nb_hash probed slots.  Union across devices/batches is elementwise
  max — the mergeability the reference exploits when unioning pools
  (kmercount.rs:810-814); across a mesh it is one ``jax.lax.pmax``.
* :class:`CountingBloom` — int32 slot array with scatter-add;
  ``estimate_count`` = min over probed slots (the CBF estimate backing
  bloom::CountingBloomFilter::estimate_count in the reference).  Saturation at
  2^nb_bits-1 mirrors the reference's 8/16-bit slots (parsearg.rs:57-58).

Slots are *unpacked* (one per lane) rather than bit-packed: scatter-OR is not
in XLA's scatter op set, scatter-max is — and HBM capacity, not bandwidth, is
what bounds filter size here.

These filters are NOT on any hot path (exact counting streams through
count/stream.py): they exist for the reference's memory-bounded
approximate regime (CBF semantics, kmercount.rs:70-123), where one insert
per BATCH of reads amortizes fine.  Their insert rate on the GPU is not
measured yet.

The reference's cuckoo "seen exactly once" semantics (insert_kmer's
delete-and-promote, kmercount.rs:241-267) are realized exactly by the sort
based counter in count/exact.py; these filters cover the streaming /
out-of-core regime where the reference accepted approximation too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.rng import splitmix64

U64 = jnp.uint64
I32 = jnp.int32


def probe_indices(keys_u64, nb_hash: int, log2_slots: int):
    """nb_hash independent slot indices per key, [..., nb_hash] int32.

    Derivation mirrors the reference's idea of deriving many hashes from one
    (nthash.rs:63-72): salt + splitmix64 finalizer per probe.
    """
    keys = jnp.asarray(keys_u64, U64)
    salts = (jnp.arange(1, nb_hash + 1, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15))
    h = splitmix64(keys[..., None] ^ salts)
    return (h & U64((1 << log2_slots) - 1)).astype(I32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BloomFilter:
    slots: jax.Array  # uint8[2^log2_slots]
    nb_hash: int = dataclasses.field(metadata=dict(static=True))
    log2_slots: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def create(log2_slots: int, nb_hash: int = 4) -> "BloomFilter":
        return BloomFilter(slots=jnp.zeros(1 << log2_slots, dtype=jnp.uint8),
                           nb_hash=nb_hash, log2_slots=log2_slots)

    def insert(self, keys_u64, mask=None) -> "BloomFilter":
        idx = probe_indices(keys_u64, self.nb_hash, self.log2_slots)
        val = jnp.ones(idx.shape, dtype=jnp.uint8)
        if mask is not None:
            val = val * mask[..., None].astype(jnp.uint8)
            idx = jnp.where(mask[..., None], idx, 0)
        slots = self.slots.at[idx.ravel()].max(val.ravel(), mode="drop")
        return dataclasses.replace(self, slots=slots)

    def contains(self, keys_u64):
        idx = probe_indices(keys_u64, self.nb_hash, self.log2_slots)
        return (self.slots[idx] > 0).all(axis=-1)

    def union(self, other: "BloomFilter") -> "BloomFilter":
        return dataclasses.replace(self, slots=jnp.maximum(self.slots, other.slots))

    def fill_fraction(self):
        return (self.slots > 0).mean()


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CountingBloom:
    slots: jax.Array  # int32[2^log2_slots]
    nb_hash: int = dataclasses.field(metadata=dict(static=True))
    log2_slots: int = dataclasses.field(metadata=dict(static=True))
    nb_bits: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def create(log2_slots: int, nb_hash: int = 4, nb_bits: int = 8) -> "CountingBloom":
        return CountingBloom(slots=jnp.zeros(1 << log2_slots, dtype=I32),
                             nb_hash=nb_hash, log2_slots=log2_slots,
                             nb_bits=nb_bits)

    @property
    def max_count(self) -> int:
        return (1 << self.nb_bits) - 1

    def insert(self, keys_u64, increments=None, mask=None) -> "CountingBloom":
        """Add each key (optionally with per-key increment) to its probed slots."""
        idx = probe_indices(keys_u64, self.nb_hash, self.log2_slots)
        if increments is None:
            inc = jnp.ones(idx.shape, dtype=I32)
        else:
            inc = jnp.broadcast_to(
                jnp.asarray(increments, I32)[..., None], idx.shape)
        if mask is not None:
            inc = inc * mask[..., None].astype(I32)
            idx = jnp.where(mask[..., None], idx, 0)
        slots = self.slots.at[idx.ravel()].add(inc.ravel(), mode="drop")
        slots = jnp.minimum(slots, self.max_count)
        return dataclasses.replace(self, slots=slots)

    def estimate_count(self, keys_u64):
        idx = probe_indices(keys_u64, self.nb_hash, self.log2_slots)
        return self.slots[idx].min(axis=-1)

    def merge(self, other: "CountingBloom") -> "CountingBloom":
        return dataclasses.replace(
            self, slots=jnp.minimum(self.slots + other.slots, self.max_count))
