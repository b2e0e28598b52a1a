"""SuperMinHash (Ertl 2017) — per-read Jaccard signatures, device-dense.

Capability twin of SuperHashSketch / SuperHash2Sketch
(/root/reference/src/sketching/setsketchert.rs:211-336, 904-1046).  The
defining structure: for item d and slot j,

    h_j(d) = pi_d(j) + u_{d,j}

where u_{d,j} ~ U[0,1) and pi_d is a random permutation of {0..m-1}, both
pure functions of d; signature_j = min_d h_j(d).  The permutation spreads
each item's small values across slots (sampling without replacement), which
cuts the estimator variance vs m independent minhashes (Ertl's result).
Unbiasedness needs only that pi_d(j) is identically distributed across items
and independent item-to-item; the variance cut needs each item to take every
permutation value exactly once — both hold for any keyed permutation family.

The reference generates pi_d by incremental Fisher-Yates inside a sequential
loop.  Here pi_d is a keyed bijection of the next-power-of-two superdomain
(odd-multiply + xorshift rounds, each bijective mod 2^b) with cycle-walking
back into [0, m), evaluated in closed form per (d, j).  Everything packs
into ONE u32 key per (d, j):

    key = pi << u_bits | u        (u = top u_bits of a 32-bit item-slot hash)

so the whole sketch is a single fused u32 min-reduction over positions —
the same shape XLA already executes at memory speed for ProbMinHash.

Two signature flavors, as in the reference:
* ``superminhash2`` — u32 packed signatures (SUPER2 role; integer, no ties)
* ``superminhash``  — float64 signatures pi + u/2^u_bits (SUPER role); an
  exact monotone transform of the packed key, so both flavors estimate
  identically (tests assert equality).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.rng import splitmix64

U32 = jnp.uint32
U64 = jnp.uint64
F64 = jnp.float64

SENTINEL32 = np.uint32(0xFFFFFFFF)
_WALKS = 4  # extra cycle-walk rounds AFTER the initial bijection, so each
            # (item, slot) pair gets 1 + _WALKS = 5 independent draws; the
            # out-of-range residual is p^5 with p = 1 - m/2^nbits: worst
            # case (dom/m just under 2) (1/2)^5 ~ 3%, typical (m=200,
            # dom=256) 0.22^5 ~ 5e-4 of pairs, which clamp to m-1 —
            # deterministic and estimator-negligible


def _perm_bits(m: int) -> int:
    return max((m - 1).bit_length(), 1)


def _encrypt_pow2(x, a_odd, b, nbits: int):
    """Keyed bijection of [0, 2^nbits): odd-multiply + xor, then xorshift —
    each step bijective mod 2^nbits, so the composition is a permutation."""
    mask = U32((1 << nbits) - 1)
    x = (x * a_odd ^ b) & mask
    x = (x ^ (x >> U32(max(nbits // 2, 1)))) & mask
    return x


def _small_perm(j, keys_u64, m: int):
    """Keyed pseudorandom permutation of [0, m) — cycle-walked keyed
    bijection of the pow2 superdomain.  j, keys_u64 broadcastable uint64."""
    nbits = _perm_bits(m)
    k1 = splitmix64(jnp.asarray(keys_u64) ^ np.uint64(0xA5A5A5A5))
    a = (k1 >> U64(32)).astype(U32) | U32(1)
    b = k1.astype(U32)
    x = jnp.asarray(j).astype(U32)
    x = _encrypt_pow2(x, a, b, nbits)
    for _ in range(_WALKS):
        out = x >= U32(m)
        x = jnp.where(out, _encrypt_pow2(x, a, b, nbits), x)
    x = jnp.minimum(x, U32(m - 1))
    return x.astype(jnp.int32)


def _fold32(items):
    items = jnp.asarray(items)
    if items.dtype == jnp.uint64:
        return (items ^ (items >> U64(32))).astype(U32)
    return items.astype(U32)


@functools.partial(jax.jit, static_argnames=("m",))
def superminhash2(items, valid, m: int, seed=0):
    """Integer-signature SuperMinHash (SUPER2): sig uint32[n, m] — the packed
    (pi << u_bits | u) key of the winning item per slot.

    items uint64/uint32[n, P], valid bool[n, P].  ``seed`` is a TRACED
    uint64 scalar (wrapping math — identical values to the old host-int
    derivation), so sweeping seeds costs one compile, not one per seed.
    """
    it32 = _fold32(items)
    pi_bits = _perm_bits(m)
    u_bits = 32 - pi_bits
    s64 = jnp.asarray(seed).astype(U64)

    # per-item permutation key (a, b) and per-slot uniform draw
    kd = splitmix64(jnp.asarray(items).astype(U64)
                    ^ (s64 * U64(0x9E3779B97F4A7C15) + U64(0x51)))
    a = (kd >> U64(32)).astype(U32) | U32(1)
    b = kd.astype(U32)
    nbits = _perm_bits(m)
    j = jnp.arange(m, dtype=np.uint32)[None, None, :]
    x = _encrypt_pow2(j, a[..., None], b[..., None], nbits)
    for _ in range(_WALKS):
        out = x >= U32(m)
        x = jnp.where(out, _encrypt_pow2(x, a[..., None], b[..., None], nbits), x)
    pi = jnp.minimum(x, U32(m - 1))

    c = U32
    sc = (splitmix64(jnp.arange(m, dtype=np.uint64)
                     + s64 * U64(0x632BE59B))
          >> U64(32)).astype(U32)
    h = (it32[..., None] ^ sc) * c(0x85EBCA77)
    h = h ^ (h >> c(13))
    h = h * c(0xC2B2AE3D)
    h = h ^ (h >> c(16))
    u = h >> U32(pi_bits)

    key = (pi << U32(u_bits)) | u
    key = jnp.where(valid[..., None], key, SENTINEL32)
    sig = jnp.min(key, axis=1)
    empty = ~valid.any(axis=1)
    return jnp.where(empty[:, None], SENTINEL32, sig), empty


@functools.partial(jax.jit, static_argnames=("m",))
def superminhash(items, valid, m: int, seed=0):
    """Float-signature SuperMinHash (SUPER; Sig = f64 in the reference):
    sig[j] = pi + u / 2^u_bits in [0, m) — an exact monotone transform of
    the packed integer signature, so both flavors estimate identically."""
    sig2, empty = superminhash2(items, valid, m, seed)
    u_bits = 32 - _perm_bits(m)
    sig = sig2.astype(F64) * F64(2.0 ** -u_bits)
    return jnp.where(empty[:, None], jnp.inf, sig), empty


def superminhash_jaccard(sig_a, sig_b):
    """Fraction of equal slots — SuperMinHash's Jaccard estimator."""
    return (jnp.asarray(sig_a) == jnp.asarray(sig_b)).mean(axis=-1)
