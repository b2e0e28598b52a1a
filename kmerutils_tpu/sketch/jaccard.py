"""High-level sequence sketchers and Jaccard drivers.

Capability twin of the SeqSketcherT trait + pairwise drivers
(/root/reference/src/sketching/setsketchert.rs:54-80,
seqsketchjaccard.rs:423-566): one entry point per algorithm, each consuming a
ReadBatch and producing per-read signatures, plus whole-collection ("seqs")
variants and one-vs-many Jaccard estimation.

The kmer hash fed to the sketchers mirrors the reference's ``fhash`` closure
(bin/datasketcher.rs:222-226): invertible Wang hash of the canonical kmer by
default, or the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..base.sequence import ReadBatch
from ..base import kmer as kmer_mod
from ..count import exact
from ..ops.rng import wang_hash32, wang_hash64
from . import probminhash, superminhash, densminhash, setsketch
from .params import SeqSketcherParams, SketchAlgo
from .setsketch import SetSketchParams

U64 = jnp.uint64

# per-Sketcher jitted whole-batch programs (Sketcher is frozen/hashable)
_JITTED: dict = {}


def hashed_kmers(batch: ReadBatch, k: int, hash_name: str = "wang"):
    """(items u64[n,P], valid bool[n,P]) — canonical kmers through fhash."""
    can, valid, _ = kmer_mod.canonical_kmers(batch, k)
    if hash_name == "wang":
        # u32 items for k <= 16 (Kmer::Val = u32 in the reference) keep the
        # whole sketch path in native 32-bit lanes
        items = wang_hash32(can) if k <= 16 else wang_hash64(can)
    elif hash_name == "identity":
        items = can
    else:
        raise ValueError(f"unknown kmer hash {hash_name}")
    return items, valid


def hashed_weighted_kmers(batch: ReadBatch, k: int, hash_name: str = "wang"):
    """items + per-read multiplicities (the weighted histogram the probminhash
    sketchers consume, setsketchert.rs:128-147)."""
    items, valid = hashed_kmers(batch, k, hash_name)
    weights, _ = exact.multiplicity_per_slot(batch, k)
    return items, weights, valid


@dataclasses.dataclass(frozen=True)
class Sketcher:
    """Algorithm-dispatched sequence sketcher (the SeqSketcherT role).

    ``sketch_batch`` runs as ONE jitted program per (params, batch shape) —
    kmer extraction, canonicalization, hashing and the sketch kernel fuse
    into a single device computation (no eager dispatch of the prefix
    ops).
    """

    params: SeqSketcherParams
    hash_name: str = "wang"
    seed: int = 0
    setsketch_params: SetSketchParams | None = None
    heavy_cap: int = 2048  # legacy knob (ProbMinHash is exact; ignored)

    def get_kmer_size(self) -> int:
        return self.params.kmer_size

    def get_sketch_size(self) -> int:
        return self.params.sketch_size

    def get_algo(self) -> SketchAlgo:
        return self.params.algo

    def _batch_fn(self):
        k, m = self.params.kmer_size, self.params.sketch_size
        algo = self.params.algo
        hash_name, seed = self.hash_name, self.seed
        sp = self.setsketch_params or SetSketchParams(m=m)

        def fn(words, lengths):
            batch = ReadBatch(words=words, lengths=lengths)
            items, valid = hashed_kmers(batch, k, hash_name)
            if algo == SketchAlgo.PROB3A:
                return probminhash.probminhash_from_items(
                    items, valid, m, seed=seed)[0]
            if algo == SketchAlgo.SUPER:
                return superminhash.superminhash(items, valid, m, seed)[0]
            if algo == SketchAlgo.SUPER2:
                return superminhash.superminhash2(items, valid, m, seed)[0]
            if algo == SketchAlgo.OPTDENS:
                return densminhash.optdens_signatures(items, valid, m, seed)[0]
            if algo == SketchAlgo.REVOPTDENS:
                return densminhash.revoptdens_signatures(items, valid, m, seed)[0]
            if algo == SketchAlgo.HLL:
                return setsketch.setsketch_signatures(items, valid, sp, seed)
            raise ValueError(f"unhandled algo {algo}")

        return fn

    # -- per-read signatures (sketch_compressedkmer) ------------------------
    def sketch_batch(self, batch: ReadBatch):
        fn = _JITTED.get(self)
        if fn is None:
            fn = jax.jit(self._batch_fn())
            _JITTED[self] = fn
        return fn(batch.words, batch.lengths)

    # -- one sketch for a whole collection (sketch_compressedkmer_seqs) -----
    def sketch_collection(self, batch: ReadBatch):
        """One signature for all reads together (setsketchert.rs:160-202).

        For HLL this is the mergeable-register path: per-read registers are
        max-merged — across a device mesh this merge is a jax.lax.pmax.
        """
        k, m = self.params.kmer_size, self.params.sketch_size
        algo = self.params.algo
        if algo == SketchAlgo.HLL:
            regs = self.sketch_batch(batch)
            return jnp.max(regs, axis=0)
        items, valid = hashed_kmers(batch, k, self.hash_name)
        flat = items.reshape(1, -1)
        fvalid = valid.reshape(1, -1)
        if algo == SketchAlgo.PROB3A:
            kc = exact.count_from_values(
                jnp.where(fvalid[0], flat[0].astype(U64), exact.SENTINEL64))
            weights = jnp.where(kc.keys != exact.SENTINEL64, kc.counts, 0)
            sig, _, _ = probminhash.probminhash_signatures(
                kc.keys[None, :], weights[None, :], m, seed=self.seed)
            return sig[0]
        if algo == SketchAlgo.SUPER:
            return superminhash.superminhash(flat, fvalid, m, self.seed)[0][0]
        if algo == SketchAlgo.SUPER2:
            return superminhash.superminhash2(flat, fvalid, m, self.seed)[0][0]
        if algo == SketchAlgo.OPTDENS:
            return densminhash.optdens_signatures(flat, fvalid, m, self.seed)[0][0]
        if algo == SketchAlgo.REVOPTDENS:
            return densminhash.revoptdens_signatures(flat, fvalid, m, self.seed)[0][0]
        raise ValueError(f"unhandled algo {algo}")

    def jaccard(self, sig_a, sig_b):
        if self.params.algo == SketchAlgo.HLL:
            sp = self.setsketch_params or SetSketchParams(m=self.params.sketch_size)
            return setsketch.jaccard(sig_a, sig_b, sp)
        return (jnp.asarray(sig_a) == jnp.asarray(sig_b)).mean(axis=-1)


def probminhash_get_jaccard_objects(sig_a, sig_b):
    """(jaccard, common objects or None) from two ProbMinHash signatures —
    twin of seqsketchjaccard.rs:86-108."""
    a = np.asarray(sig_a)
    b = np.asarray(sig_b)
    eq = a == b
    jp = float(eq.mean())
    if jp > 0:
        return jp, a[eq].tolist()
    return 0.0, None


def compute_probminhash3a_jaccard(weighted_a: dict, weighted_b: dict,
                                  sketch_size: int, return_object: bool = False,
                                  seed: int = 0):
    """Weighted-set Probability-Jaccard from two {item: weight} mappings —
    twin of compute_probminhash3a_jaccard (seqsketchjaccard.rs:58-83)."""
    def sig_of(d):
        items = np.fromiter(d.keys(), dtype=np.uint64,
                            count=len(d))[None, :]
        w = np.fromiter(d.values(), dtype=np.int64, count=len(d))[None, :]
        s, _, _ = probminhash.probminhash_signatures(
            items, w.astype(np.int32), sketch_size, seed=seed)
        return np.asarray(s)[0]

    sa, sb = sig_of(weighted_a), sig_of(weighted_b)
    if not return_object:
        return float((sa == sb).mean()), None
    return probminhash_get_jaccard_objects(sa, sb)


def jaccard_one_vs_many(seq_a: ReadBatch, seqs_b: ReadBatch,
                        params: SeqSketcherParams, hash_name: str = "wang",
                        seed: int = 0):
    """Twin of jaccard_index_probminhash3a (seqsketchjaccard.rs:423-495):
    sketch seq_a (batch of 1), sketch every seq in seqs_b, return the vector
    of estimated Jaccard indices ordered by rank."""
    sk = Sketcher(params=params, hash_name=hash_name, seed=seed)
    sig_a = sk.sketch_batch(seq_a)[0]
    sig_b = sk.sketch_batch(seqs_b)
    if params.algo == SketchAlgo.HLL:
        sp = sk.setsketch_params or SetSketchParams(m=params.sketch_size)
        return setsketch.jaccard(sig_b, jnp.asarray(sig_a)[None, :], sp)
    return (jnp.asarray(sig_b) == jnp.asarray(sig_a)[None, :]).mean(axis=-1)
