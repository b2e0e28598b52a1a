"""DNA alphabet codecs (2/4/8-bit), vectorized over byte tensors.

Capability twin of /root/reference/src/base/alphabet.rs — same encodings:

* ``Alphabet2b`` — A=0b00, C=0b01, G=0b10, T=0b11 (lexicographic order kept;
  complement == bitwise NOT), 4 bases per byte, first base in the high bits
  (alphabet.rs:119-168).
* ``Alphabet4b`` — A=0b0001, C=0b0010, G=0b0100, T=0b1000, N=0b1111,
  2 bases per byte (alphabet.rs:232-297).
* ``Alphabet8b`` — identity (alphabet.rs:328-367).

Unlike the reference, encoding here is table-lookup over whole numpy/jnp byte
arrays, not per-char matches; on-device code only ever sees 2-bit codes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# host-side (numpy) lookup tables
# ---------------------------------------------------------------------------

# ASCII -> 2-bit code; invalid -> 0xFF
ENCODE_2B = np.full(256, 0xFF, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ENCODE_2B[_b] = _i
    ENCODE_2B[_b + 32] = _i  # lowercase
DECODE_2B = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

ENCODE_4B = np.full(256, 0xFF, dtype=np.uint8)
for _b, _c in zip(b"ACGTNZ", (0b0001, 0b0010, 0b0100, 0b1000, 0b1111, 0b0000)):
    ENCODE_4B[_b] = _c
    if _b != ord("Z"):
        ENCODE_4B[_b + 32] = _c
DECODE_4B = np.full(16, ord("Z"), dtype=np.uint8)
for _b, _c in zip(b"ACGTN", (0b0001, 0b0010, 0b0100, 0b1000, 0b1111)):
    DECODE_4B[_c] = _b

COMPLEMENT_4B = np.zeros(16, dtype=np.uint8)
for _c, _cc in ((0b0001, 0b1000), (0b0010, 0b0100), (0b0100, 0b0010),
                (0b1000, 0b0001), (0b1111, 0b1111)):
    COMPLEMENT_4B[_c] = _cc

IS_ACGT = ENCODE_2B != 0xFF


def is_acgt(ascii_bytes) -> np.ndarray:
    """Vectorized twin of alphabet.rs:15-17 (``is_acgt``)."""
    return IS_ACGT[np.asarray(ascii_bytes, dtype=np.uint8)]


def count_non_acgt(ascii_bytes) -> int:
    """Twin of alphabet.rs:28-31."""
    return int((~is_acgt(ascii_bytes)).sum())


def get_ac_from_tg(c: int) -> int:
    """Lower conjugate of a base: T->A, G->C, others unchanged — twin of
    alphabet.rs:20-26 (used by parsefastq's return-times option)."""
    return {ord("T"): ord("A"), ord("G"): ord("C")}.get(int(c), int(c))


def encode_2b(ascii_bytes) -> np.ndarray:
    """ASCII -> 2-bit codes (0..3); invalid bases map to 0xFF."""
    return ENCODE_2B[np.asarray(ascii_bytes, dtype=np.uint8)]


def decode_2b(codes) -> np.ndarray:
    """2-bit codes -> ASCII."""
    return DECODE_2B[np.asarray(codes, dtype=np.uint8) & 0b11]


def complement_2b(codes):
    """Complement of a 2-bit code is its bitwise NOT (alphabet.rs:141-149)."""
    return (~np.asarray(codes, dtype=np.uint8)) & 0b11


def encode_4b(ascii_bytes) -> np.ndarray:
    return ENCODE_4B[np.asarray(ascii_bytes, dtype=np.uint8)]


def decode_4b(codes) -> np.ndarray:
    return DECODE_4B[np.asarray(codes, dtype=np.uint8) & 0x0F]


# ---------------------------------------------------------------------------
# device-side (jnp) helpers
# ---------------------------------------------------------------------------

def complement_2b_jnp(codes):
    return (~jnp.asarray(codes)) & jnp.asarray(0b11, dtype=jnp.asarray(codes).dtype)


def base_counts(codes, valid_mask=None):
    """Count occurrences of each 2-bit base code.  Returns shape (..., 4).

    ``codes``: integer array of 2-bit codes; ``valid_mask`` masks padding.
    Twin of Sequence::base_count (sequence.rs:333-364), but batched.
    """
    codes = jnp.asarray(codes)
    one_hot = (codes[..., None] == jnp.arange(4, dtype=codes.dtype))
    if valid_mask is not None:
        one_hot = one_hot & valid_mask[..., None]
    # int32 accumulation: reads are < 2^31 bases
    return one_hot.sum(axis=-2, dtype=jnp.int32)
