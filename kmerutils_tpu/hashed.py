"""Hashed-item wrappers — twins of /root/reference/src/hashed.rs.

The reference threads (hash, maybe-item) pairs through its minhash heaps:
``ItemHash = u64``; ``HashedItem{hash, Option<item>}`` ordered by hash;
``HashCount{hashed, count u16}``; plus invertible-hash flavors that drop the
item since it is recoverable (``InvHashedItem``/``InvHashCount{count u8}``,
hashed.rs:60-113).

On the device these never exist per-object — sketches are (hash array, count array)
pairs (sketch/minhash.py).  These dataclasses are the host-side boundary
types for users porting code from the reference, with the same ordering and
recovery semantics.

The reference's ``NoHashHasher`` (/root/reference/src/nohasher.rs:11-49) — an
identity Hasher letting pre-hashed values pass through std collections — has
no device counterpart by construction: hashes here are plain integer tensors,
identity passthrough is the default everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Generic, Optional, TypeVar

from .ops.rng import wang_hash32_inv, wang_hash64_inv

T = TypeVar("T")


@dataclasses.dataclass(frozen=True, order=True)
class HashedItem(Generic[T]):
    """(hash, item) ordered by hash (hashed.rs:23-46)."""
    hash: int
    item: Optional[T] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True, order=True)
class HashCount(Generic[T]):
    """Hashed item + multiplicity (hashed.rs:49-57; count u16 there)."""
    hashed: HashedItem
    count: int = dataclasses.field(default=1, compare=False)


@dataclasses.dataclass(frozen=True, order=True)
class InvHashedItem:
    """Invertible-hashed kmer: only the hash is stored, the kmer value is
    recoverable (hashed.rs:60-89)."""
    hash: int
    wide: bool = dataclasses.field(default=False, compare=False)

    def recover(self) -> int:
        """Invert back to the kmer value (minhash.rs:223-233 semantics)."""
        import numpy as np
        if self.wide:
            return int(wang_hash64_inv(np.uint64(self.hash)))
        return int(wang_hash32_inv(np.uint32(self.hash)))


@dataclasses.dataclass(frozen=True, order=True)
class InvHashCount:
    """InvHashedItem + count (hashed.rs:92-113; count u8 there)."""
    hashed: InvHashedItem
    count: int = dataclasses.field(default=1, compare=False)
