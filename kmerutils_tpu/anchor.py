"""Anchors: per-window invertible-minhash signatures of reads + KV export.

Capability twin of /root/reference/src/anchor.rs + redisbase.rs: each read is
cut into sliding windows (step = window - overlap, anchor.rs:306-325); every
window gets a bottom-``nbkmer`` invertible minhash over its kmers
(gen_anchor_mininvhash, :228-258); anchors persist to a key-value store with
the reference's exact key/value string encodings (redisbase.rs:29-196) — the
store backend is pluggable (in-memory dict by default, a real redis client if
the ``redis`` package is importable).

Device form: all windows of all reads are rows of one [n_windows, window_size]
kmer-slot matrix fed to the batched bottom-k kernel — the sliding-window loop
vanishes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from .base.sequence import ReadBatch
from .base import kmer as kmer_mod
from .sketch import minhash

U64 = jnp.uint64

# redisbase.rs:29-40 key-schema constants
FN_KEY = "prop:fn"
PROCESS_KEY = "prop:fn:process"
NB_BASES_KEY = "prop:fn:process:bases"
SLICE_SIZE_KEY = "prop:fn:process:ssize"
POS_KEY = "prop:fn:process:readnum:slicepos"
MINHASH_1 = "prop:fn:process:minhash_1"
MINHASH_2 = "prop:fn:process:minhash_2"
SLICE_ANCHOR_KEY = "prop:fn:process:ssize:bases:readnum:slicepos"


@dataclasses.dataclass(frozen=True)
class AnchorsGeneratorParameters:
    """anchor.rs:29-78."""
    fasta_name: str
    window: int
    nbkmer: int
    kmer_size: int
    overlap: int

    def __post_init__(self):
        if self.window <= self.overlap or self.window <= 0:
            raise ValueError("window must exceed overlap (anchor.rs:295-296)")


@dataclasses.dataclass
class SliceAnchor:
    """anchor.rs:97-120: (readnum, slicepos) key + bottom-k (hash, count)."""
    readnum: int
    slicepos: int
    minhash: list[tuple[int, int]]  # (invhash value, count)

    def value_string(self) -> str:
        """SliceAnchorValueRedis encoding: 'h,c:h,c:...' (redisbase.rs:52-77)."""
        return ":".join(f"{h},{c}" for h, c in self.minhash)

    @staticmethod
    def from_value_string(readnum: int, slicepos: int, s: str) -> "SliceAnchor":
        pairs = []
        for couple in s.split(":"):
            h, c = couple.split(",")
            pairs.append((int(h), int(c)))
        return SliceAnchor(readnum, slicepos, pairs)

    def key_string(self, params: AnchorsGeneratorParameters,
                   process: str = "anchor") -> str:
        """SliceAnchorKeyRedis field order (redisbase.rs:134-163)."""
        return (f"{params.fasta_name}:{process}:{params.window}:"
                f"{params.kmer_size}:{self.readnum}:{self.slicepos}")


def compute_anchors(batch: ReadBatch, params: AnchorsGeneratorParameters,
                    read_num_offset: int = 0) -> list[SliceAnchor]:
    """All sliding-window anchors of a read batch, one batched kernel call."""
    k = params.kmer_size
    wide = k > 16
    if k <= 16:
        km, valid = kmer_mod.kmers_u32(batch, k)
        km = km.astype(U64)
    else:
        km, valid = kmer_mod.kmers_u64(batch, k)
    n, P = km.shape
    step = params.window - params.overlap
    lengths = np.asarray(batch.lengths)
    max_w = max(1, -(-int(lengths.max(initial=1)) // step))
    # window w covers kmer positions [w*step, w*step + window)
    idx = (np.arange(max_w)[:, None] * step + np.arange(params.window)[None, :])
    idx_c = np.minimum(idx, P - 1)
    km_w = jnp.asarray(km)[:, idx_c]            # [n, max_w, window]
    va_w = jnp.asarray(valid)[:, idx_c] & jnp.asarray(idx[None] < P)
    km_f = km_w.reshape(n * max_w, params.window)
    va_f = va_w.reshape(n * max_w, params.window)
    sk, counts = minhash.sketch_items_invhash(km_f, va_f, params.nbkmer, wide=wide)
    sk = np.asarray(sk).reshape(n, max_w, params.nbkmer)
    counts = np.asarray(counts).reshape(n, max_w, params.nbkmer)
    # reference iterates beg = 0, step, ... while beg < seqlen (:306-325);
    # assembly is numpy-vectorized (live windows + slot masks computed in
    # bulk, per-element conversion via C-speed .tolist()) so the host tail
    # stays device-bound at ONT scale
    live_w = (np.arange(max_w)[None, :] * step) < lengths[:, None]
    slot_ok = sk != np.uint64(minhash.SENTINEL)
    out = []
    for i, w in zip(*np.nonzero(live_w)):
        m = slot_ok[i, w]
        pairs = list(zip(sk[i, w][m].tolist(), counts[i, w][m].tolist()))
        out.append(SliceAnchor(read_num_offset + int(i), int(w) * step,
                               pairs))
    return out


class AnchorStore:
    """KV persistence of anchors with the reference's schema; backend is a
    dict (or any mapping-like with hset/hget semantics)."""

    def __init__(self):
        self.hashes: dict[str, dict[str, str]] = {}

    def hset(self, key: str, field: str, value: str):
        self.hashes.setdefault(key, {})[field] = value

    def dump_anchors(self, params: AnchorsGeneratorParameters,
                     anchors: list[SliceAnchor], process: str = "anchor"):
        """SliceAnchor::redis_dump + inverse index (anchor.rs:124-203)."""
        for a in anchors:
            self.hset(SLICE_ANCHOR_KEY, a.key_string(params, process),
                      a.value_string())
            if a.minhash:
                # inverse index: smallest minhash -> slice (MINHASH_1 schema)
                self.hset(MINHASH_1, str(a.minhash[0][0]),
                          f"{a.readnum}:{a.slicepos}")

    def load_anchor(self, params: AnchorsGeneratorParameters, readnum: int,
                    slicepos: int, process: str = "anchor") -> SliceAnchor | None:
        key = SliceAnchor(readnum, slicepos, []).key_string(params, process)
        v = self.hashes.get(SLICE_ANCHOR_KEY, {}).get(key)
        if v is None:
            return None
        return SliceAnchor.from_value_string(readnum, slicepos, v)


class RedisAnchorStore(AnchorStore):
    """AnchorStore backed by a live redis-protocol connection — the
    reference's redis_dump target (anchor.rs:166-203 + redisbase.rs),
    speaking RESP over TCP via the from-scratch client in ``kvstore.py``
    (works against stock redis or :class:`kvstore.RespServer`).  Bulk
    dumps pipeline every HSET in one round trip and issue BGREWRITEAOF
    afterwards like anchor_computation (anchor.rs:460-467)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0):
        from .kvstore import RespClient
        super().__init__()
        self._r = RespClient(host=host, port=port, db=db)

    def hset(self, key: str, field: str, value: str):
        super().hset(key, field, value)
        self._r.hset(key, field, value)

    def load_anchor(self, params: AnchorsGeneratorParameters, readnum: int,
                    slicepos: int, process: str = "anchor"
                    ) -> SliceAnchor | None:
        """Read back THROUGH the wire (not the local mirror) so reloads
        see anchors persisted by other processes."""
        key = SliceAnchor(readnum, slicepos, []).key_string(params, process)
        v = self._r.hget(SLICE_ANCHOR_KEY, key)
        if v is None:
            return None
        return SliceAnchor.from_value_string(readnum, slicepos, v)

    def dump_anchors(self, params, anchors, process: str = "anchor"):
        # mirror locally (base-class hset, NOT the wire-writing override)
        # and ship every write as ONE pipelined round trip
        cmds = []
        for a in anchors:
            key, val = a.key_string(params, process), a.value_string()
            AnchorStore.hset(self, SLICE_ANCHOR_KEY, key, val)
            cmds.append(("HSET", SLICE_ANCHOR_KEY, key, val))
            if a.minhash:
                inv_f, inv_v = str(a.minhash[0][0]), \
                    f"{a.readnum}:{a.slicepos}"
                AnchorStore.hset(self, MINHASH_1, inv_f, inv_v)
                cmds.append(("HSET", MINHASH_1, inv_f, inv_v))
        if cmds:
            self._r.pipeline(cmds)
        try:
            self._r.bgrewriteaof()
        except Exception:
            pass  # AOF disabled server-side is fine

    def close(self):
        self._r.close()


def anchor_computation(fasta_path: str, params: AnchorsGeneratorParameters,
                       store: AnchorStore | None = None):
    """Whole-file driver (FastaAnchors::anchor_computation, anchor.rs:398-467):
    parse, drop non-ACGT reads, anchor every read, optionally persist."""
    from .io import fastx
    all_anchors = []
    offset = 0
    for batch, idx in fastx.read_batches(fasta_path, bucket=False):
        anchors = compute_anchors(batch, params, read_num_offset=offset)
        all_anchors.extend(anchors)
        offset += len(idx)  # real reads only (batch may be shape-padded)
    if store is not None:
        store.dump_anchors(params, all_anchors)
    return all_anchors
