"""Classic bottom-k MinHash with counts, plus the invertible-hash variant.

Capability twin of /root/reference/src/sketching/minhash.rs: MinHashCount
(BinaryHeap of smallest distinct hashes + count map, :29-131),
MinInvHashCountKmer (stores only the invertible hashes since kmers are
recoverable, :194-290) and the distance functions returning
(containment, jaccard, common, total) (:134-190, :295-340).

Device form: per-read sort of item hashes, run-length dedup, keep the S smallest
distinct hashes and their occurrence counts — all static-shape.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.rng import splitmix64, wang_hash32, wang_hash64, wang_hash32_inv, wang_hash64_inv

U64 = jnp.uint64
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("size",))
def bottomk_sketch(hashes, valid, size: int):
    """Smallest ``size`` distinct hash values per read, with counts.

    hashes uint64[n, P], valid bool[n, P] ->
    (sketch uint64[n, size] padded SENTINEL, counts int32[n, size]).
    """
    h = jnp.where(valid, jnp.asarray(hashes, U64), SENTINEL)
    s = jnp.sort(h, axis=1)
    n, P = s.shape
    is_real = s != SENTINEL
    new_run = jnp.concatenate([jnp.ones((n, 1), bool), s[:, 1:] != s[:, :-1]],
                              axis=1) & is_real
    # run length per position via two scans (no segment-sum / scatter)
    idx = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None, :], (n, P))
    start = jax.lax.cummax(jnp.where(new_run, idx, -1), axis=1)
    nxt = jnp.where(new_run | ~is_real, idx, P)
    rev_min = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
    next_start = jnp.concatenate(
        [rev_min[:, 1:], jnp.full((n, 1), P, jnp.int32)], axis=1)
    run_count = next_start - start
    # compact distinct values to the front with one variadic re-sort
    dv, dc = jax.lax.sort(
        (jnp.where(new_run, s, SENTINEL),
         jnp.where(new_run, run_count, 0)), dimension=1, num_keys=1)
    return dv[:, :size], dc[:, :size]


def sketch_items(items, valid, size: int, seed: int = 0):
    """Bottom-k sketch of splitmix-hashed items (MinHashCount with a real
    hash function)."""
    h = splitmix64(jnp.asarray(items, U64) ^ np.uint64(seed))
    return bottomk_sketch(h, valid, size)


def sketch_items_invhash(items, valid, size: int, wide: bool = False):
    """Bottom-k of invertible-hashed kmers (MinInvHashCountKmer): the sketch
    stores only hashes; kmers are recoverable via :func:`invert_sketch`."""
    items = jnp.asarray(items)
    if wide:
        h = wang_hash64(items.astype(U64))
    else:
        h = wang_hash32(items.astype(jnp.uint32)).astype(U64)
    return bottomk_sketch(h, valid, size)


def invert_sketch(sketch, wide: bool = False):
    """Recover kmer values from an invhash sketch (minhash.rs:223-233)."""
    s = jnp.asarray(sketch)
    if wide:
        return wang_hash64_inv(s.astype(U64))
    return wang_hash32_inv(s.astype(jnp.uint32))


def minhash_distance(sk_a, sk_b):
    """(containment, jaccard, common, total) from two bottom-k sketches —
    the reference's merge-walk estimate (minhash.rs:134-190): walk the two
    sorted lists, count matches among the first ``size`` smallest of the
    union.
    """
    a = np.asarray(sk_a).astype(np.uint64)
    b = np.asarray(sk_b).astype(np.uint64)
    a = a[a != SENTINEL]
    b = b[b != SENTINEL]
    size = max(len(a), len(b))
    i = j = 0
    common = 0
    total = 0
    while i < len(a) and j < len(b) and total < size:
        if a[i] < b[j]:
            i += 1
        elif b[j] < a[i]:
            j += 1
        else:
            i += 1
            j += 1
            common += 1
        total += 1
    if total < size:
        total = min(size, total + (len(a) - i) + (len(b) - j))
    containment = common / max(i, 1)
    jaccard = common / max(total, 1)
    return containment, jaccard, common, total
