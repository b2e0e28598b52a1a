"""ntHash (Mohamadi–Chu–Birol 2016) for whole read batches, in closed form.

Capability twin of /root/reference/src/base/nthash.rs and of the rolling
implementations macro-generated for 2-bit kmers in base/kmer.rs:45-145.  Same
seeds (nthash.rs:17-20), same MULTISEED/MULTISHIFT multi-hash derivation
(nthash.rs:10-13,63-72), same canonical (min(fhash, rhash), strand) rule.

Device formulation: the reference cycles h' = rotl1(h) ^ rotl(seed_out,k)
^ seed_in, one position at a time.  That recurrence has the closed form

    fhash(p) = XOR_{i=0..k-1} rotl(seed[b_{p+i}], k-1-i)
             = rotl( W(p), (k-1+p) mod 64 ),   W(p) = XOR_{j=p}^{p+k-1} t_j,
    t_j      = rotr(seed[b_j], j mod 64)

and XOR windows come from a prefix-XOR scan: W(p) = px[p+k] ^ px[p] where
px is the exclusive prefix XOR of t.  Likewise for the reverse-complement
hash with complement seeds rotated left by j:

    rhash(p) = rotr( XOR_{j=p}^{p+k-1} u_j, p mod 64 ),  u_j = rotl(cseed[b_j], j mod 64)

One associative scan + O(1) work per position replaces the serial cycle; the
values are bit-identical to the reference's (verified against the recurrence
in tests/test_nthash.py, mirroring nthash.rs:302-381).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .sequence import ReadBatch
from ..ops.bitops import rotl64, rotr64

U64 = jnp.uint64

# 64-bit base seeds, nthash.rs:17-20
SEED_A = np.uint64(0x3C8BFBB395C60474)
SEED_C = np.uint64(0x3193C18562A02B4C)
SEED_G = np.uint64(0x20323ED082572324)
SEED_T = np.uint64(0x295549F54BE24456)

# indexed by 2-bit code; complement table is the reverse (A<->T, C<->G),
# cf. BASE_MAPPING_2B nthash.rs:28-30
SEEDS_2B = np.array([SEED_A, SEED_C, SEED_G, SEED_T], dtype=np.uint64)
CSEEDS_2B = np.array([SEED_T, SEED_G, SEED_C, SEED_A], dtype=np.uint64)

# multi-hash constants, nthash.rs:10-13
MULTISHIFT = 27
MULTISEED = np.uint64(0x90B45D39FB6DA1FA)


def _prefix_xor(x, axis: int):
    """Inclusive prefix XOR via parallel associative scan."""
    return jax.lax.associative_scan(jnp.bitwise_xor, x, axis=axis)


def nthash_kmers(batch: ReadBatch, k: int):
    """Forward, reverse and canonical ntHash of every k-mer of every read.

    Returns (fhash, rhash, canonical, strand, valid), each [n_reads, P] with
    P = max_len - k + 1.  strand==0 when fhash <= rhash (nthash.rs:223-227).
    """
    codes = batch.codes()  # uint8 [n, L]
    n, L = codes.shape
    P = max(batch.max_len - k + 1, 1)

    j = jnp.arange(L, dtype=jnp.uint64)
    seeds = jnp.asarray(SEEDS_2B)[codes]       # [n, L] uint64
    cseeds = jnp.asarray(CSEEDS_2B)[codes]
    t = rotr64(seeds, j[None, :])              # rotr(seed, j % 64)
    u = rotl64(cseeds, j[None, :])

    # inclusive scans -> window XOR via px[p+k-1] ^ px[p-1]
    pt = _prefix_xor(t, axis=1)
    pu = _prefix_xor(u, axis=1)

    def window(px):
        hi = jax.lax.slice_in_dim(px, k - 1, k - 1 + P, axis=1)
        lo = jnp.pad(jax.lax.slice_in_dim(px, 0, P - 1, axis=1),
                     ((0, 0), (1, 0)))
        return hi ^ lo

    p = jnp.arange(P, dtype=jnp.uint64)[None, :]
    fhash = rotl64(window(pt), (U64(k - 1) + p))
    rhash = rotr64(window(pu), p)

    strand = (rhash < fhash).astype(jnp.uint8)
    canonical = jnp.minimum(fhash, rhash)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos + k <= batch.lengths[:, None]
    return fhash, rhash, canonical, strand, valid


def multi_hash(h0, k: int, nb_hash: int):
    """Derive nb_hash values from one: hashed[i] = f(h0, i) for i in 1..nb_hash,
    hashed[0] = h0 — twin of from_one_hash_val_to_mult_hash (nthash.rs:63-72).

    Returns [..., nb_hash] uint64.
    """
    h0 = jnp.asarray(h0, U64)
    i = jnp.arange(1, nb_hash, dtype=np.uint64)
    tmp = h0[..., None] * (i ^ (U64(k) * MULTISEED))
    tmp = tmp ^ (tmp >> U64(MULTISHIFT))
    return jnp.concatenate([h0[..., None], tmp], axis=-1)


def nthash_kmers_ascii(reads, k: int):
    """ntHash over raw ASCII reads — the reference's 8-bit free-function
    family (nthash_init_8b / cycle / canonical, nthash.rs:153-287).

    The 8-bit seed table BASE_MAPPING_8B maps ASCII A/C/G/T to the SAME four
    seeds as the 2-bit table (nthash.rs:28-57), so hashing the 2-bit packed
    form yields bit-identical values; this wrapper just packs and delegates.
    """
    from .sequence import pack_ascii_reads
    return nthash_kmers(pack_ascii_reads(reads), k)


# ---------------------------------------------------------------------------
# scalar golden-model (host) used by tests — direct transcription of the
# mathematical definition (getFhval/getRhval, nthash.rs:153-228)
# ---------------------------------------------------------------------------

def nthash_init_ref(codes2b) -> int:
    codes2b = np.asarray(codes2b, dtype=np.uint8)
    k = codes2b.size
    h = np.uint64(0)
    for i, c in enumerate(codes2b):
        r = (k - i - 1) % 64
        s = SEEDS_2B[c]
        h ^= np.uint64((int(s) << r | int(s) >> (64 - r)) & ((1 << 64) - 1)) if r else s
    return int(h)


def nthash_rcomp_init_ref(codes2b) -> int:
    codes2b = np.asarray(codes2b, dtype=np.uint8)
    h = 0
    for i, c in enumerate(codes2b):
        r = i % 64
        s = int(CSEEDS_2B[c])
        h ^= ((s << r) | (s >> (64 - r))) & ((1 << 64) - 1) if r else s
    return h
