"""Batched k-mer extraction and canonicalization.

Capability twin of the reference's KmerSeqIterator / KmerGenerator
(/root/reference/src/base/kmergenerator.rs:30-186) and of the Kmer32bit /
Kmer16b32bit / Kmer64bit value semantics (kmer32bit.rs, kmer16b32bit.rs,
kmer64bit.rs) — but instead of an object-per-kmer rolling iterator, every
k-mer of every read materializes in one shot:

  For position p in a read, the k-mer value is the big-endian 2-bit integer of
  bases p..p+k-1.  With reads packed 16 bases/uint32-word (first base in the
  top bits), the 32-bit window starting at base p is

      win32(p) = (words[p>>4] << 2*(p&15)) | (words[p>>4 + 1] >> (32-2*(p&15)))

  and the k-mer is win32(p) >> (32-2k).  The gather indices p>>4 and shifts
  2*(p&15) depend only on p, so they are trace-time constants — XLA sees two
  static gathers plus a handful of elementwise ops per k-mer.  For k > 16 the
  same trick runs on a 64-bit window built from three words.

k-mer *values* are bit-identical to the reference's compressed values
(kmer32bit.rs:173-178 value field; kmer64bit.rs word; kmer16b32bit.rs raw u32).
Canonicalization is min(kmer, revcomp(kmer)) exactly as kmercount.rs:313.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .sequence import ReadBatch, BASES_PER_WORD
from ..ops.bitops import revcomp_u32, revcomp_u64

U32 = jnp.uint32
U64 = jnp.uint64


def kmers_u32(batch: ReadBatch, k: int):
    """All k-mers (k <= 16) of every read.

    Returns (kmers, valid):
      kmers: uint32[n_reads, P] — value of k-mer starting at each position,
      valid: bool[n_reads, P]   — position p valid iff p + k <= length.
    P = max_len - k + 1 positions per read (static).

    Gather-free: word i covers the 16 start positions 16i..16i+15, whose
    32-bit windows are (w[i] << 2j) | (w[i+1] >> (32-2j)) for j = 0..15 — a
    [n, n_words-1, 16] broadcast of shifts (the shift amount is a trace-time
    constant per lane), reshaped to the position axis.  No gathers, pure elementwise work.
    """
    if not 1 <= k <= 16:
        raise ValueError("kmers_u32 requires 1 <= k <= 16")
    w = batch.words
    P = max(batch.max_len - k + 1, 1)
    w0 = w[:, :-1, None]                                 # [n, W-1, 1]
    w1 = w[:, 1:, None]
    j2 = jnp.asarray(2 * np.arange(BASES_PER_WORD), U32)[None, None, :]
    lo = jnp.where(j2 == 0, U32(0), w1 >> ((U32(32) - j2) % U32(32)))
    win = ((w0 << j2) | lo).reshape(w.shape[0], -1)      # [n, (W-1)*16]
    kmers = win[:, :P] >> U32(32 - 2 * k)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos + k <= batch.lengths[:, None]
    return kmers, valid


def kmers_u64(batch: ReadBatch, k: int):
    """All k-mers (17 <= k <= 32, also fine for smaller k) as uint64.

    Same gather-free scheme as :func:`kmers_u32` on a 64-bit window built
    from three consecutive words.
    """
    if not 1 <= k <= 32:
        raise ValueError("kmers_u64 requires 1 <= k <= 32")
    w = batch.words
    n, W = w.shape
    P = max(batch.max_len - k + 1, 1)
    # third word: shift the slack-padded array left by 2 (zero fill)
    w2_src = jnp.pad(w[:, 2:], ((0, 0), (0, 2)))
    d = (w[:, :-1, None].astype(U64) << U64(32)) | w[:, 1:, None].astype(U64)
    w2 = w2_src[:, :-1, None].astype(U64)
    j2 = jnp.asarray(2 * np.arange(BASES_PER_WORD), np.uint64)[None, None, :]
    lo = jnp.where(j2 == 0, U64(0), w2 >> ((U64(32) - j2) % U64(64)))
    win = ((d << j2) | lo).reshape(n, -1)
    kmers = win[:, :P] >> U64(64 - 2 * k)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos + k <= batch.lengths[:, None]
    return kmers, valid


def canonical_u32(kmers, k: int):
    """(min(kmer, revcomp), strand) with strand=1 when the revcomp is strictly
    smaller — matching kmin = kmer.reverse_complement().min(*kmer)
    (kmercount.rs:313) and the nthash strand convention."""
    rc = revcomp_u32(kmers, k)
    strand = (rc < kmers).astype(jnp.uint8)
    return jnp.minimum(kmers, rc), strand


def canonical_u64(kmers, k: int):
    rc = revcomp_u64(kmers, k)
    strand = (rc < kmers).astype(jnp.uint8)
    return jnp.minimum(kmers, rc), strand


def canonical_kmers(batch: ReadBatch, k: int):
    """Convenience: extract + canonicalize; uint32 path when k <= 16."""
    if k <= 16:
        km, valid = kmers_u32(batch, k)
        can, strand = canonical_u32(km, k)
    else:
        km, valid = kmers_u64(batch, k)
        can, strand = canonical_u64(km, k)
    return can, valid, strand


def kmer_coordinates(batch: ReadBatch, k: int, read_num_offset: int = 0):
    """(read_num, pos) pairs for every k-mer slot — twin of KmerCoord
    (/root/reference/src/base/kmer.rs:30-35)."""
    P = max(batch.max_len - k + 1, 1)
    read_num = jnp.arange(batch.n_reads, dtype=jnp.uint32)[:, None] + U32(read_num_offset)
    pos = jnp.arange(P, dtype=jnp.uint32)[None, :]
    return jnp.broadcast_to(read_num, (batch.n_reads, P)), jnp.broadcast_to(pos, (batch.n_reads, P))


# ---------------------------------------------------------------------------
# host-side golden-value helpers (for tests & format parity)
# ---------------------------------------------------------------------------

def kmer_value_from_str(s: str) -> int:
    """2-bit big-endian integer value of an ACGT string — the reference's
    compressed value (kmer32bit.rs:186-208 FromStr + get_compressed_value)."""
    from . import alphabet
    v = 0
    for c in alphabet.encode_2b(np.frombuffer(s.encode(), dtype=np.uint8)):
        if c == 0xFF:
            raise ValueError("non-ACGT base")
        v = (v << 2) | int(c)
    return v


def kmer_str_from_value(v: int, k: int) -> str:
    from . import alphabet
    codes = [(v >> (2 * (k - 1 - i))) & 3 for i in range(k)]
    return alphabet.decode_2b(np.array(codes, dtype=np.uint8)).tobytes().decode()
