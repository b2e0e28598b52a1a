"""Sequence storage: host-side packed bytes (reference-compatible) and the
device-resident batched representation all kernels operate on.

Two layers:

* :class:`Sequence` — byte-compatible twin of the reference's ``Sequence``
  (/root/reference/src/base/sequence.rs:14-106): Vec<u8> of packed bases plus a
  2-byte descriptor [nb_bits_by_base, nb_bases_in_last_byte].  Used for format
  parity (dump/reload, golden tests); never on the hot path.

* :class:`ReadBatch` — the device form: a [n_reads, W] uint32 tensor where
  each word holds 16 consecutive 2-bit bases, first base in the highest bits,
  plus an int32 length vector.  This layout makes k-mer extraction a pair of
  static gathers + shifts (see base/kmer.py) and keeps HBM traffic at 2
  bits/base.  Padding bases are 0 ('A') and masked via lengths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from . import alphabet

BASES_PER_WORD = 16


# ---------------------------------------------------------------------------
# host-side reference-compatible Sequence
# ---------------------------------------------------------------------------

class Sequence:
    """Byte-packed sequence with the reference's exact layout.

    2-bit mode packs 4 bases/byte with the first base in bits 7..6
    (sequence.rs:48-72); partial last byte padded with 'A'.  4-bit mode packs
    2 bases/byte, padded with 'Z'=0 (sequence.rs:75-92).  8-bit is raw.
    """

    __slots__ = ("seq", "nb_bits", "nb_bases")

    def __init__(self, raw: bytes | np.ndarray, nb_bits: int = 2):
        raw = np.frombuffer(bytes(raw), dtype=np.uint8) if isinstance(
            raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.uint8)
        self.nb_bits = nb_bits
        self.nb_bases = int(raw.size)
        if nb_bits == 8:
            self.seq = raw.copy()
        elif nb_bits == 2:
            codes = alphabet.encode_2b(raw)
            if (codes == 0xFF).any():
                raise ValueError("non-ACGT base in 2-bit sequence")
            pad = (-self.nb_bases) % 4
            codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
            c = codes.reshape(-1, 4).astype(np.uint8)
            self.seq = (c[:, 0] << 6) | (c[:, 1] << 4) | (c[:, 2] << 2) | c[:, 3]
        elif nb_bits == 4:
            codes = alphabet.encode_4b(raw)
            if (codes == 0xFF).any():
                raise ValueError("invalid base in 4-bit sequence")
            pad = (-self.nb_bases) % 2
            codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
            c = codes.reshape(-1, 2)
            self.seq = (c[:, 0] << 4) | c[:, 1]
        else:
            raise ValueError("nb_bits must be 2, 4 or 8")

    # descriptor bytes, as in sequence.rs:14-20
    @property
    def description(self):
        per = 8 // self.nb_bits
        return (self.nb_bits, self.nb_bases % per)

    def size(self) -> int:
        """Logical number of bases (sequence.rs:222-234)."""
        return self.nb_bases

    def get_base(self, pos: int) -> int:
        """Encoded base at pos (sequence.rs:120-136)."""
        nb = self.nb_bits
        if nb == 8:
            return int(self.seq[pos])
        per = 8 // nb
        byte = self.seq[pos // per]
        off = nb * (pos % per)
        return (byte >> (8 - off - nb)) & ((1 << nb) - 1)

    def codes(self) -> np.ndarray:
        """All encoded bases as a dense uint8 vector."""
        nb = self.nb_bits
        if nb == 8:
            return self.seq.copy()
        if nb == 2:
            b = self.seq
            out = np.empty(b.size * 4, dtype=np.uint8)
            out[0::4] = b >> 6
            out[1::4] = (b >> 4) & 3
            out[2::4] = (b >> 2) & 3
            out[3::4] = b & 3
            return out[: self.nb_bases]
        b = self.seq
        out = np.empty(b.size * 2, dtype=np.uint8)
        out[0::2] = b >> 4
        out[1::2] = b & 0x0F
        return out[: self.nb_bases]

    def decompress(self) -> bytes:
        """ASCII bases (sequence.rs:142-218)."""
        if self.nb_bits == 8:
            return self.seq.tobytes()
        dec = alphabet.decode_2b if self.nb_bits == 2 else alphabet.decode_4b
        return dec(self.codes()).tobytes()

    def reverse_complement(self) -> "Sequence":
        """Twin of sequence.rs:252-315 (2-bit fast path semantics)."""
        if self.nb_bits == 2:
            codes = self.codes()
            rc = alphabet.complement_2b(codes)[::-1]
            return Sequence(alphabet.decode_2b(rc), 2)
        if self.nb_bits == 8:
            comp = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}
            raw = bytes(comp.get(b, b) for b in self.seq[::-1])
            return Sequence(raw, 8)
        codes = self.codes()
        rc = alphabet.COMPLEMENT_4B[codes][::-1]
        return Sequence(alphabet.decode_4b(rc), 4)


class IterSequence:
    """Forward + double-ended base iterator over a packed :class:`Sequence`,
    with range restriction — twin of the reference's IterSequence
    (/root/reference/src/base/sequence.rs:499-722): ``set_range(begin, end)``
    (:562-585), forward ``next`` (:605-649), backward ``next_back``
    (:667-722).  ``decode=True`` yields ASCII bases instead of codes
    (:588-591).
    """

    __slots__ = ("_codes", "_decode", "_front", "_back", "_table")

    def __init__(self, seq: "Sequence", decode: bool = False):
        self._codes = seq.codes()
        self._decode = decode
        self._table = {2: alphabet.DECODE_2B, 4: alphabet.DECODE_4B,
                       8: None}[seq.nb_bits]
        self._front = 0
        self._back = seq.size()

    def set_range(self, begin: int, end: int) -> None:
        if not (0 <= begin < end <= self._codes.size):
            raise ValueError("bad range for IterSequence (sequence.rs:566-572)")
        self._front = begin
        self._back = end

    def _emit(self, code: int):
        if self._decode and self._table is not None:
            return int(self._table[code])
        return int(code)

    def __iter__(self):
        return self

    def __next__(self):
        if self._front >= self._back:
            raise StopIteration
        c = self._codes[self._front]
        self._front += 1
        return self._emit(c)

    def next(self):
        """Option-style forward step: None when exhausted."""
        if self._front >= self._back:
            return None
        c = self._codes[self._front]
        self._front += 1
        return self._emit(c)

    def next_back(self):
        """Backward step from the end of the range (DoubleEndedIterator)."""
        if self._back <= self._front:
            return None
        self._back -= 1
        return self._emit(self._codes[self._back])


# ---------------------------------------------------------------------------
# device-side batched representation
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """A batch of 2-bit packed reads, device resident.

    words:   uint32[n_reads, n_words] — 16 bases per word, first base of each
             group in the word's top 2 bits; one extra zero word of slack is
             ALWAYS present at the end (n_words >= ceil(max_len/16) + 1) so
             k-mer extraction can read word i+1/i+2 unconditionally.
    lengths: int32[n_reads] — logical base counts (padding beyond is zeros).
    """

    words: jax.Array
    lengths: jax.Array

    @property
    def n_reads(self) -> int:
        return self.words.shape[0]

    @property
    def max_len(self) -> int:
        # usable base capacity excluding the slack word
        return (self.words.shape[1] - 1) * BASES_PER_WORD

    def codes(self) -> jax.Array:
        """Unpack to per-base 2-bit codes, uint8[n_reads, n_words*16]."""
        w = self.words
        shifts = (30 - 2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))
        c = (w[:, :, None] >> shifts[None, None, :]) & jnp.uint32(3)
        return c.reshape(w.shape[0], -1).astype(jnp.uint8)

    def valid_mask(self) -> jax.Array:
        """bool[n_reads, n_words*16] — True where a real base exists."""
        L = self.words.shape[1] * BASES_PER_WORD
        pos = jnp.arange(L, dtype=jnp.int32)
        return pos[None, :] < self.lengths[:, None]


def pack_codes(codes: np.ndarray, lengths: np.ndarray | None = None,
               min_words: int | None = None,
               as_numpy: bool = False) -> ReadBatch:
    """Pack per-base 2-bit codes [n_reads, max_len] (numpy) into a ReadBatch.

    Padding positions (>= length) must already be 0, or lengths given so we
    can zero them here.  ``as_numpy=True`` keeps the arrays on the host
    (no device transfer) — the ingest pipeline's dedicated upload stage
    then owns the transfer (io/fastx.read_batches_overlapped).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.ndim == 1:
        codes = codes[None, :]
    n, L = codes.shape
    if lengths is None:
        lengths = np.full(n, L, dtype=np.int32)
    else:
        lengths = np.asarray(lengths, dtype=np.int32)
        mask = np.arange(L)[None, :] < lengths[:, None]
        codes = np.where(mask, codes, 0)
    n_words = -(-L // BASES_PER_WORD) + 1  # +1 slack word
    if min_words is not None:
        n_words = max(n_words, min_words)
    padded = np.zeros((n, n_words * BASES_PER_WORD), dtype=np.uint8)
    padded[:, :L] = codes
    c = padded.reshape(n, n_words, BASES_PER_WORD).astype(np.uint32)
    shifts = (30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32))
    words = np.bitwise_or.reduce(c << shifts[None, None, :], axis=2).astype(np.uint32)
    if as_numpy:
        return ReadBatch(words=words, lengths=lengths)
    return ReadBatch(words=jnp.asarray(words), lengths=jnp.asarray(lengths))


def pack_ascii_reads(reads, min_words: int | None = None) -> ReadBatch:
    """Pack a list of ASCII reads (bytes/str), dropping nothing: caller is
    responsible for filtering non-ACGT reads (io.rs:41-48 semantics live in
    kmerutils_tpu.io.fastx)."""
    arrs = []
    for r in reads:
        if isinstance(r, str):
            r = r.encode()
        a = alphabet.encode_2b(np.frombuffer(bytes(r), dtype=np.uint8))
        if (a == 0xFF).any():
            raise ValueError("non-ACGT base in read; filter before packing")
        arrs.append(a)
    n = len(arrs)
    L = max((a.size for a in arrs), default=0)
    codes = np.zeros((n, L), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, a in enumerate(arrs):
        codes[i, : a.size] = a
        lengths[i] = a.size
    return pack_codes(codes, lengths, min_words=min_words)


def revcomp_batch(batch: ReadBatch) -> ReadBatch:
    """Reverse-complement every read in the batch (device-side).

    Uses the unpacked-code path: complement = ~code, order reversed per read
    honoring each read's length.
    """
    codes = batch.codes()
    L = codes.shape[1]
    comp = (~codes) & np.uint8(3)
    # reverse within each read's logical extent: new[j] = old[len-1-j]
    idx = batch.lengths[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
    idx = jnp.clip(idx, 0, L - 1)
    rc = jnp.take_along_axis(comp, idx, axis=1)
    mask = jnp.arange(L, dtype=jnp.int32)[None, :] < batch.lengths[:, None]
    rc = jnp.where(mask, rc, 0).astype(jnp.uint8)
    # repack on device
    n_words = L // BASES_PER_WORD
    c = rc.reshape(batch.n_reads, n_words, BASES_PER_WORD).astype(jnp.uint32)
    shifts = (30 - 2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))
    # codes occupy disjoint bit ranges, so sum == bitwise-or
    words = (c << shifts[None, None, :]).sum(axis=2, dtype=jnp.uint32)
    return ReadBatch(words=words.astype(jnp.uint32), lengths=batch.lengths)
