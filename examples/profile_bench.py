"""Per-stage timing of the headline ProbMinHash pipeline on the default backend.

Stages (steady state: N queued iterations, then jax.block_until_ready):
  1. extract+hash   : packed words -> canonical 8-mer wang hashes
  2. sort           : row sort of the hashed items
  3. scans          : run multiplicities (cummax + reverse cummin)
  4. tournament     : fused weighted tournament
  5. full           : the complete jitted step
"""
import time
import numpy as np
import kmerutils_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from kmerutils_tpu.base.sequence import pack_codes, ReadBatch
from kmerutils_tpu.sketch.jaccard import hashed_kmers
from kmerutils_tpu.sketch import probminhash

K, M, READ_LEN, N_READS = 8, 200, 6000, 1024

rng = np.random.default_rng(42)
codes = rng.integers(0, 4, size=(N_READS, READ_LEN), dtype=np.uint8)
lengths = np.full(N_READS, READ_LEN, dtype=np.int32)
batch = pack_codes(codes, lengths)
words = jax.device_put(batch.words)
lens = jax.device_put(batch.lengths)


def timeit(fn, *args, n=20):
    jax.block_until_ready(fn(*args))  # warm (compile)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


@jax.jit
def stage_extract(words, lens):
    items, valid = hashed_kmers(ReadBatch(words=words, lengths=lens), K)
    return items[0, :8], items, valid

_, items, valid = stage_extract(words, lens)
items = jax.device_put(np.asarray(items))
valid = jax.device_put(np.asarray(valid))
sent = np.uint32(0xFFFFFFFF) if items.dtype == jnp.uint32 else np.uint64(-1)

@jax.jit
def stage_sort(items, valid):
    s = jnp.sort(jnp.where(valid, items, sent), axis=1)
    return s[0, :8], s

s = jax.device_put(np.asarray(stage_sort(items, valid)[1]))

@jax.jit
def stage_scans(s):
    is_real = s != sent
    w = probminhash._run_multiplicities(s, is_real)
    return w[0, :8], w

w = jax.device_put(np.asarray(stage_scans(s)[1]))

@jax.jit
def stage_tournament(s, w):
    is_real = s != sent
    winv = jnp.float32(1.0) / jnp.maximum(w, 1).astype(jnp.float32)
    sig, empty = probminhash._tournament(s, winv, is_real, M, 0)
    return sig[0, :8]

@jax.jit
def full(words, lens):
    items, valid = hashed_kmers(ReadBatch(words=words, lengths=lens), K)
    sig, _, _ = probminhash.probminhash_from_items(items, valid, M)
    return sig[0, :8]

print("items dtype:", items.dtype, "shape:", items.shape)
for name, fn, args in [
    ("extract+hash", stage_extract, (words, lens)),
    ("sort        ", stage_sort, (items, valid)),
    ("scans       ", stage_scans, (s,)),
    ("tournament  ", stage_tournament, (s, w)),
    ("FULL        ", full, (words, lens)),
]:
    dt = timeit(fn, *args)
    print(f"{name}: {dt*1e3:8.2f} ms")
