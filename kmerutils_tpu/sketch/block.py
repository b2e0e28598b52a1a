"""Block sketching of long reads + block distance.

Capability twin of BlockSeqSketcher / DistBlockSketched
(/root/reference/src/sketching/seqblocksketch.rs): a long read is split into
fixed ``block_size`` windows, each window gets its own ProbMinHash signature
(one FnvHashMap + ProbMinHash3a per block in the reference, :97-149), and the
distance between two blocks is 1.0 if they come from the same read, else the
fraction of unequal sketch slots (Probability-Jaccard distance, :417-440).

Device form: the [n_reads, P] kmer-slot grid reshapes to
[n_reads * n_blocks, block_size] and the whole thing goes through the same
dense probminhash kernel — blocks are just more rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..base.sequence import ReadBatch
from . import probminhash
from .jaccard import hashed_kmers

U64 = jnp.uint64


@dataclasses.dataclass(frozen=True)
class BlockSketchResult:
    """sigs uint64[n_reads, n_blocks, m]; a block is live when it contains at
    least one valid kmer position."""
    sigs: np.ndarray
    live: np.ndarray  # bool[n_reads, n_blocks]
    block_size: int
    kmer_size: int


def block_sketch(batch: ReadBatch, k: int, m: int, block_size: int,
                 hash_name: str = "wang", seed: int = 0) -> BlockSketchResult:
    """Sketch every ``block_size`` window of kmer start positions of every
    read (block i covers positions [i*bs, (i+1)*bs), seqblocksketch.rs:97-149)."""
    items, valid = hashed_kmers(batch, k, hash_name)
    n, P = items.shape
    nb = -(-P // block_size)
    pad = nb * block_size - P
    items = jnp.pad(items, ((0, 0), (0, pad)))
    valid = jnp.pad(valid, ((0, 0), (0, pad)))
    items = items.reshape(n * nb, block_size)
    valid = valid.reshape(n * nb, block_size)
    sig, empty, _ = probminhash.probminhash_from_items(
        items, valid, m, heavy_cap=min(256, block_size), seed=seed)
    return BlockSketchResult(
        sigs=np.asarray(sig).reshape(n, nb, m),
        live=~np.asarray(empty).reshape(n, nb),
        block_size=block_size, kmer_size=k)


def dist_block_sketched(numseq_a: int, sig_a, numseq_b: int, sig_b) -> float:
    """DistBlockSketched (seqblocksketch.rs:417-440): 1.0 for blocks of the
    same read, else fraction of unequal slots."""
    if numseq_a == numseq_b:
        return 1.0
    a = np.asarray(sig_a)
    b = np.asarray(sig_b)
    return float((a != b).mean())


def flatten_for_dump(res: BlockSketchResult, read_indices=None):
    """-> list of (numseq, [block_sigs u32 ...]) for
    io.formats.write_block_signature_dump; signatures are truncated to u32
    (the reference's Sig=u32 block sketch)."""
    out = []
    n, nb, m = res.sigs.shape
    if read_indices is not None:
        n = min(n, len(read_indices))  # rows beyond are batch shape-padding
    for i in range(n):
        numseq = int(read_indices[i]) if read_indices is not None else i
        blocks = [res.sigs[i, j].astype(np.uint32)
                  for j in range(nb) if res.live[i, j]]
        if blocks:
            out.append((numseq, blocks))
    return out
