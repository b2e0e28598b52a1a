"""ANN export / neighbor search over signatures.

The reference hands signatures to hnsw_rs (Hnsw<u32, DistHamming>,
/root/reference/src/bin/datasketcher.rs:156-195,263-309) and dumps the graph.
The device counterpart: the signature matrix lives on device and neighbor
search is a tiled all-pairs slot-equality reduction (DistHamming on sketch
slots) + top-k — dense elementwise compare ops, no pointer-chasing graph.
For huge corpora the tiling streams blocks through HBM; signatures also
round-trip through the reference-format dump (io/formats.py) so an external
HNSW can consume them unchanged.
"""

from __future__ import annotations

import struct

import numpy as np
import jax
import jax.numpy as jnp


def hamming_similarity_block(a, b):
    """Fraction of equal slots for every pair: a [na, m], b [nb, m] ->
    [na, nb] float32 (1 - DistHamming of the reference)."""
    eq = (jnp.asarray(a)[:, None, :] == jnp.asarray(b)[None, :, :])
    return eq.mean(axis=-1).astype(jnp.float32)


def brute_force_neighbors(sigs, nbng: int, block: int = 1024,
                          exclude_self: bool = True):
    """Top-``nbng`` neighbors per read by signature similarity.

    Returns (neighbors int32[n, nbng], similarity float32[n, nbng]).
    """
    sigs = np.asarray(sigs)
    n = sigs.shape[0]
    nbng = min(nbng, n - 1 if exclude_self else n)
    sim_fn = jax.jit(hamming_similarity_block)
    all_nn = np.zeros((n, nbng), dtype=np.int32)
    all_sim = np.zeros((n, nbng), dtype=np.float32)
    dev_sigs = jnp.asarray(sigs)
    for start in range(0, n, block):
        q = dev_sigs[start : start + block]
        sim = sim_fn(q, dev_sigs)
        if exclude_self:
            rows = jnp.arange(q.shape[0]) + start
            sim = sim.at[jnp.arange(q.shape[0]), rows].set(-1.0)
        top_sim, top_idx = jax.lax.top_k(sim, nbng)
        all_nn[start : start + q.shape[0]] = np.asarray(top_idx)
        all_sim[start : start + q.shape[0]] = np.asarray(top_sim)
    return all_nn, all_sim


NEIGHBOR_MAGIC = 0xCEA7A77D


def write_neighbor_dump(fname: str, neighbors, similarities) -> None:
    """Binary neighbor table: u32 magic | u32 n | u32 nbng | per read:
    (u32 neighbor, f32 similarity) * nbng."""
    nn = np.asarray(neighbors, dtype=np.uint32)
    sim = np.asarray(similarities, dtype=np.float32)
    n, k = nn.shape
    rec = np.zeros((n, k), dtype=[("i", "<u4"), ("s", "<f4")])
    rec["i"] = nn
    rec["s"] = sim
    with open(fname, "wb") as f:
        f.write(struct.pack("<III", NEIGHBOR_MAGIC, n, k))
        f.write(rec.tobytes())


def read_neighbor_dump(fname: str):
    with open(fname, "rb") as f:
        magic, n, k = struct.unpack("<III", f.read(12))
        if magic != NEIGHBOR_MAGIC:
            raise ValueError("bad magic for neighbor dump")
        rec = np.frombuffer(f.read(), dtype=[("i", "<u4"), ("s", "<f4")])
    rec = rec.reshape(n, k)
    return rec["i"].copy(), rec["s"].copy()
