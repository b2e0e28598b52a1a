"""Vectorized bit manipulation primitives on uint32 / uint64 lanes.

These are the building blocks for 2-bit-packed k-mer arithmetic: rotations,
2-bit-group reversal (for reverse complements), and shifts that are safe for
the full [0, nbits] shift range (lane shifts by >= width are undefined in XLA,
like in C).

All functions are shape-polymorphic elementwise jnp ops; they trace cleanly
under jit / vmap / shard_map and lower to plain elementwise device code.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
U64 = jnp.uint64

_M32 = np.uint64(0xFFFFFFFF)


def rotl(x, r, nbits: int):
    """Rotate left by r (r may be a traced array; any value, taken mod nbits)."""
    dtype = x.dtype
    r = jnp.asarray(r, dtype) % dtype.type(nbits)
    # shift-by-width is UB; (nbits - r) % nbits keeps both shifts in [0, nbits)
    rr = (dtype.type(nbits) - r) % dtype.type(nbits)
    return jnp.where(r == 0, x, (x << r) | (x >> rr))


def rotr(x, r, nbits: int):
    dtype = x.dtype
    r = jnp.asarray(r, dtype) % dtype.type(nbits)
    rl = (dtype.type(nbits) - r) % dtype.type(nbits)
    return jnp.where(r == 0, x, (x >> r) | (x << rl))


def rotl64(x, r):
    return rotl(x, r, 64)


def rotr64(x, r):
    return rotr(x, r, 64)


def rotl32(x, r):
    return rotl(x, r, 32)


def shl_safe(x, s, nbits: int):
    """x << s, returning 0 when s >= nbits (also handles s == nbits)."""
    dtype = x.dtype
    s = jnp.asarray(s, dtype)
    return jnp.where(s >= dtype.type(nbits), dtype.type(0), x << (s % dtype.type(nbits)))


def shr_safe(x, s, nbits: int):
    dtype = x.dtype
    s = jnp.asarray(s, dtype)
    return jnp.where(s >= dtype.type(nbits), dtype.type(0), x >> (s % dtype.type(nbits)))


def reverse_base_pairs_u32(x):
    """Reverse the order of the 16 2-bit groups of a uint32.

    Equivalent to the reference's ``reverse_bits`` followed by the adjacent-bit
    swap (Hacker's Delight symmetry), cf. /root/reference/src/base/kmer16b32bit.rs:43-54,
    but expressed as a mask ladder (no bit-reverse op in XLA):
    swap 2-bit groups within nibbles, nibbles within bytes, then byte-reverse.
    """
    x = jnp.asarray(x, U32)
    c = U32
    x = ((x & c(0x33333333)) << c(2)) | ((x >> c(2)) & c(0x33333333))
    x = ((x & c(0x0F0F0F0F)) << c(4)) | ((x >> c(4)) & c(0x0F0F0F0F))
    x = ((x & c(0x00FF00FF)) << c(8)) | ((x >> c(8)) & c(0x00FF00FF))
    x = (x << c(16)) | (x >> c(16))
    return x


def reverse_base_pairs_u64(x):
    """Reverse the order of the 32 2-bit groups of a uint64
    (cf. /root/reference/src/base/kmer64bit.rs:83-96)."""
    x = jnp.asarray(x, U64)
    c = U64
    x = ((x & c(0x3333333333333333)) << c(2)) | ((x >> c(2)) & c(0x3333333333333333))
    x = ((x & c(0x0F0F0F0F0F0F0F0F)) << c(4)) | ((x >> c(4)) & c(0x0F0F0F0F0F0F0F0F))
    x = ((x & c(0x00FF00FF00FF00FF)) << c(8)) | ((x >> c(8)) & c(0x00FF00FF00FF00FF))
    x = ((x & c(0x0000FFFF0000FFFF)) << c(16)) | ((x >> c(16)) & c(0x0000FFFF0000FFFF))
    x = (x << c(32)) | (x >> c(32))
    return x


def revcomp_u32(kmer, k: int):
    """Canonical-order reverse complement of a k-mer (k <= 16) stored in the
    low 2k bits of a uint32, 2-bit encoded A=00 C=01 G=10 T=11 (complement is
    bitwise NOT — the encoding conjugates A<->T, C<->G).

    Matches /root/reference/src/base/kmer16b32bit.rs:43-54 / kmer32bit.rs:119-137.
    """
    x = jnp.asarray(kmer, U32)
    x = reverse_base_pairs_u32(~x)
    if k < 16:
        x = x >> U32(32 - 2 * k)
    return x


def revcomp_u64(kmer, k: int):
    """Reverse complement of a k-mer (k <= 32) in the low 2k bits of a uint64
    (cf. /root/reference/src/base/kmer64bit.rs:83-96)."""
    x = jnp.asarray(kmer, U64)
    x = reverse_base_pairs_u64(~x)
    if k < 32:
        x = x >> U64(64 - 2 * k)
    return x
