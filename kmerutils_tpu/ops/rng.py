"""Counter-based hashing / RNG primitives used across counting and sketching.

The reference routes k-mers to shards and builds min-hash signatures through
the ``invhash`` module of the external ``probminhash`` crate (invertible
32/64-bit integer hashes credited to Thomas Wang), e.g.
/root/reference/src/base/kmercount.rs:382-420 and
/root/reference/src/sketching/minhash.rs:194-290.  The crate source is not in
the snapshot; we implement Thomas Wang's published invertible hashes
(hash32shiftmult and hash64shift) plus exact inverses.  All sketching RNG is
counter-based (splitmix64) so every (item, slot) random draw is an independent
pure function — the device replacement for the reference's stateful
per-item xoshiro streams.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
U64 = jnp.uint64

_GOLDEN64 = np.uint64(0x9E3779B97F4A7C15)


def wang_hash32(x):
    """Thomas Wang's invertible 32-bit mix (hash32shiftmult).

    Fills the role of probminhash::invhash::int32_hash (shard dispatch of u32
    kmers, kmer-recoverable minhash signatures).
    """
    x = jnp.asarray(x, U32)
    c = U32
    x = (x ^ c(61)) ^ (x >> c(16))
    x = x + (x << c(3))
    x = x ^ (x >> c(4))
    x = x * c(0x27D4EB2D)
    x = x ^ (x >> c(15))
    return x


def wang_hash32_inv(x):
    """Exact inverse of :func:`wang_hash32`."""
    x = jnp.asarray(x, U32)
    c = U32
    # invert x ^= x >> 15  (applied twice covers 32 bits)
    x = x ^ (x >> c(15)) ^ (x >> c(30))
    # invert multiply by 0x27D4EB2D (odd -> invertible mod 2^32)
    x = x * c(pow(0x27D4EB2D, -1, 1 << 32))
    # invert x ^= x >> 4 (xor-shift inverse: xor all shift powers < 32)
    x = x ^ (x >> c(4)) ^ (x >> c(8)) ^ (x >> c(12)) ^ (x >> c(16)) \
        ^ (x >> c(20)) ^ (x >> c(24)) ^ (x >> c(28))
    # invert x += x << 3  i.e. x *= 9
    x = x * c(pow(9, -1, 1 << 32))
    # invert (x ^ 61) ^ (x >> 16)
    x = x ^ (x >> c(16))
    x = x ^ c(61)
    return x


def wang_hash64(x):
    """Thomas Wang's invertible 64-bit hash (hash64shift).

    Fills the role of probminhash::invhash::int64_hash.
    """
    x = jnp.asarray(x, U64)
    c = U64
    x = (~x) + (x << c(21))
    x = x ^ (x >> c(24))
    x = (x + (x << c(3))) + (x << c(8))  # x * 265
    x = x ^ (x >> c(14))
    x = (x + (x << c(2))) + (x << c(4))  # x * 21
    x = x ^ (x >> c(28))
    x = x + (x << c(31))
    return x


def wang_hash64_inv(x):
    """Exact inverse of :func:`wang_hash64`."""
    x = jnp.asarray(x, U64)
    c = U64
    # invert x += x << 31  (x *= 2^31 + 1)
    x = x * c(pow((1 << 31) + 1, -1, 1 << 64))
    # invert x ^= x >> 28
    x = x ^ (x >> c(28)) ^ (x >> c(56))
    # invert x *= 21
    x = x * c(pow(21, -1, 1 << 64))
    # invert x ^= x >> 14
    y = x
    for _ in range(5):
        y = x ^ (y >> c(14))
    x = y
    # invert x *= 265
    x = x * c(pow(265, -1, 1 << 64))
    # invert x ^= x >> 24
    x = x ^ (x >> c(24)) ^ (x >> c(48))
    # invert x = ~x + (x << 21)  i.e. x = x*(2^21+1) via ~... :
    # forward: y = (~x) + (x << 21) = x * (2^21 - 1) ... careful:
    # (~x) = -x - 1 (mod 2^64), so y = x*(2^21 - 1) - 1
    x = (x + c(1)) * c(pow((1 << 21) - 1, -1, 1 << 64))
    return x


def splitmix64(x):
    """SplitMix64 finalizer: high-quality 64-bit mix, counter-based."""
    x = jnp.asarray(x, U64)
    c = U64
    x = x + _GOLDEN64
    x = (x ^ (x >> c(30))) * c(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> c(27))) * c(0x94D049BB133111EB)
    return x ^ (x >> c(31))


def mix2_64(a, b):
    """Mix two 64-bit values into one well-distributed 64-bit value."""
    a = jnp.asarray(a, U64)
    b = jnp.asarray(b, U64)
    return splitmix64(a ^ (splitmix64(b) + _GOLDEN64))


def uniform01_from_bits(u64bits):
    """Map uint64 -> float64 uniform in (0, 1] (never 0, so log() is safe).

    Uses the top 53 bits; (x + 1) * 2^-53 over x in [0, 2^53-1].
    """
    x = jnp.asarray(u64bits, U64) >> U64(11)
    return (x.astype(jnp.float64) + 1.0) * np.float64(2.0**-53)


def uniform01_f32_from_bits(u32bits):
    """Map uint32 -> float32 uniform in (0, 1] using the top 24 bits."""
    x = jnp.asarray(u32bits, U32) >> U32(8)
    return (x.astype(jnp.float32) + 1.0) * np.float32(2.0**-24)
