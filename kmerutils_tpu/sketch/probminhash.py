"""ProbMinHash — per-read Probability-Jaccard signatures, device-dense.

Capability twin of ProbHash3aSketch
(/root/reference/src/sketching/setsketchert.rs:85-203): the reference builds a
per-read weighted histogram of hashed kmers and feeds it to the sequential
ProbMinHash3a of the probminhash crate.  ProbMinHash3a is an *algorithmic
speedup* of the defining sampler (Ertl 2019 / Moulton-Jiang): signature slot
s receives  argmin_x  E_s(x)  with  E_s(x) ~ Exp(weight(x))  drawn as a pure
function of (item x, slot s).  Any implementation of that sampler satisfies
P(sig_s^A == sig_s^B) = J_P(A, B) — the Probability Jaccard.

Single-phase device design (instead of the crate's heap + xoshiro
streams): every position p carries its item's multiplicity w_p (identical for
duplicate occurrences, so duplicates are harmless — they contribute the same
draw).  Slot s's winner is

    argmin_p  E(p, s) = -ln(U(item_p, s)) / w_p

computed as ONE fused max-reduction over a packed 64-bit key per (p, s):

    key = (~bits(E) as u64) << 32 | tiebreak

where bits(E) is the IEEE-754 pattern of the f32 exponential draw (monotone
for positive floats, so ~bits orders by decreasing E) and tiebreak is the
folded item value (u32 items; ties resolved by item identity keep the sampler
a pure function of the item multiset) or the position index (u64 items; a
final cheap gather recovers the item).  XLA fuses hash + draw + pack into the
max-reduce so the [n, P, m] intermediate never touches HBM.

Multiplicities come from one sort per read plus two associative scans (run
start via cummax, next-run start via reverse cummin) — no segment-sum, no
scatter, no heavy-item compaction.

Signatures hold *item values* (the hashed kmer, Kmer::Val in the reference),
so downstream Jaccard estimation is slot-equality counting, identical in
spirit to compute_probminhash_jaccard (seqsketchjaccard.rs:58-108).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.rng import splitmix64

U32 = jnp.uint32
U64 = jnp.uint64
F32 = jnp.float32
I32 = jnp.int32

SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _slot_consts(m: int, seed):
    # wraparound multiply intended (u64 mul == the old host-int + mask);
    # seed is TRACED so a seed sweep costs one compile, not one per seed
    off = jnp.asarray(seed).astype(U64) * U64(0x9E3779B97F4A7C15)
    s = splitmix64(jnp.arange(m, dtype=np.uint64) + off)
    return (s >> U64(32)).astype(U32)


def _fold32(items):
    items = jnp.asarray(items)
    if items.dtype == jnp.uint64:
        return (items ^ (items >> U64(32))).astype(U32)
    return items.astype(U32)


def _hash32(items32, slotc):
    """H(x, s) uint32 — xorshift-multiply mix; only the top 24 bits feed the
    draw and they are fully avalanched after the second multiply."""
    c = U32
    h = items32[..., None] ^ slotc
    h = h * c(0x9E3779B1)
    h = h ^ (h >> c(15))
    h = h * c(0x85EBCA77)
    return h


def _neg_log_u24(h_u32):
    """-ln(uniform(0,1]) from the top 24 bits of a u32 hash, f32.

    u = (h24 + 1) * 2^-24 computed as one fma (exact: h24 + 1 <= 2^24)."""
    u = ((jnp.asarray(h_u32, U32) >> U32(8)).astype(F32) * F32(2.0**-24)
         + F32(2.0**-24))
    return -jnp.log(u)


def _tournament(items, winv, valid, m: int, seed):
    """Fused weighted argmin-of-exponentials over positions, per slot.

    items [n, P] u32/u64, winv f32 [n, P] (1/multiplicity), valid bool [n, P].
    Returns (sig [n, m] same dtype as items, empty bool [n]).

    One fused max-reduction over a packed 64-bit key per (position, slot):
    high 32 bits order by the exponential draw (~bits(E) — IEEE f32 patterns
    of positive floats are monotone), low 32 bits carry the COMPLEMENT of
    the item (ties resolve to the smallest item, keeping the sampler a pure
    function of the weighted item set) or of the position index for u64
    items (recovered by one gather; ties resolve to the first position,
    which on the sorted rows of probminhash_from_items is again the
    smallest item).  There are no matrix products here, so TF32 matmul
    precision plays no part; the one float op is the f32 ``log``.
    """
    items = jnp.asarray(items)
    wide = items.dtype == jnp.uint64
    empty = ~valid.any(axis=1)

    slotc = _slot_consts(m, seed)
    it32 = _fold32(items)

    H = _hash32(it32, slotc)                                   # [n, P, m]
    # abs() turns the -0.0 of a u==1 draw into +0.0 so the best possible
    # draw wins (bit pattern 0) instead of losing under ~bits ordering
    E = jnp.abs(_neg_log_u24(H) * winv[..., None].astype(F32))
    ebits = ~jax.lax.bitcast_convert_type(E, U32)              # max ~bits == min E
    if wide:
        n, P = items.shape
        payload = ~jnp.arange(P, dtype=U32)[None, :, None]     # ~position idx
    else:
        payload = ~it32[..., None]
    key = (ebits.astype(U64) << U64(32)) | payload.astype(U64)
    key = jnp.where(valid[..., None], key, U64(0))             # losers
    best = jnp.max(key, axis=1)                                # [n, m]

    if wide:
        idx = (~(best & U64(0xFFFFFFFF)).astype(U32)).astype(I32)
        sig = jnp.take_along_axis(items, idx, axis=1)
    else:
        sig = ~(best & U64(0xFFFFFFFF)).astype(U32)
    return jnp.where(empty[:, None], jnp.zeros((), items.dtype), sig), empty


@functools.partial(jax.jit, static_argnames=("m", "heavy_cap"))
def probminhash_signatures(items, weights, m: int, heavy_cap: int = 0,
                           seed=0):
    """Per-read ProbMinHash signatures from slot-aligned (item, weight) pairs.

    items:   uint64/uint32[n, P] — hashed kmer value per position (the fhash
             closure of the reference, datasketcher.rs:222-226).
    weights: int32[n, P] — multiplicity of the item within its read; 0 marks
             invalid/padding.  Duplicate occurrences may all carry the weight.
    m:       sketch size.
    heavy_cap: ignored (kept for API compatibility) — the single-phase
             tournament is always exact, there is no heavy-item buffer.

    Returns (sig [n, m] (items dtype), empty bool[n], overflow bool[n]
    — always False).
    """
    del heavy_cap
    items = jnp.asarray(items)
    weights = jnp.asarray(weights, I32)
    valid = weights > 0
    winv = F32(1.0) / jnp.maximum(weights, 1).astype(F32)
    sig, empty = _tournament(items, winv, valid, m, seed)
    return sig, empty, jnp.zeros(items.shape[0], bool)


def _run_multiplicities(sorted_items, is_real):
    """Per-position run length of sorted rows via two associative scans."""
    n, P = sorted_items.shape
    new_run = jnp.concatenate(
        [jnp.ones((n, 1), bool),
         sorted_items[:, 1:] != sorted_items[:, :-1]], axis=1) & is_real
    idx = jnp.broadcast_to(jnp.arange(P, dtype=I32)[None, :], (n, P))
    start = jax.lax.cummax(jnp.where(new_run, idx, I32(-1)), axis=1)
    # sentinels terminate the preceding run: they count as boundaries too,
    # else the last real run would absorb the padding into its length
    nxt = jnp.where(new_run | ~is_real, idx, I32(P))
    rev_min = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]    # min over q >= p
    next_start = jnp.concatenate(
        [rev_min[:, 1:], jnp.full((n, 1), P, I32)], axis=1)    # min over q > p
    return next_start - start


@functools.partial(jax.jit, static_argnames=("m", "heavy_cap"))
def probminhash_from_items(items, valid, m: int, heavy_cap: int = 0,
                           seed: int = 0):
    """Fused fast path: multiplicities derived internally by one sort.

    items [n, P] (u32 or u64) with a valid mask; weights are the within-row
    multiplicities (the reference's per-read FnvHashMap histogram,
    setsketchert.rs:128-147).  One sort groups duplicates; run lengths fall
    out of two scans; the tournament runs on the sorted rows (same multiset,
    same signature).  ``heavy_cap`` is ignored (exact for any multiplicity).
    """
    del heavy_cap
    items = jnp.asarray(items)
    wide = items.dtype == jnp.uint64
    sent = SENTINEL64 if wide else np.uint32(0xFFFFFFFF)
    s = jnp.sort(jnp.where(valid, items, sent), axis=1)
    is_real = s != sent
    w = _run_multiplicities(s, is_real)
    winv = F32(1.0) / jnp.maximum(w, 1).astype(F32)
    sig, empty = _tournament(s, winv, is_real, m, seed)
    return sig, empty, jnp.zeros(items.shape[0], bool)


def probjaccard_pair(sig_a, sig_b):
    """Fraction of equal slots — unbiased estimator of Probability Jaccard."""
    sig_a = jnp.asarray(sig_a)
    sig_b = jnp.asarray(sig_b)
    return (sig_a == sig_b).mean(axis=-1)


def probjaccard_one_vs_many(sig_a, sigs_b):
    """sig_a [m] vs sigs_b [n, m] -> [n] — twin of
    jaccard_index_probminhash3a's shape (seqsketchjaccard.rs:423-495)."""
    return probjaccard_pair(jnp.asarray(sigs_b), jnp.asarray(sig_a)[None, :])


def probjaccard_matrix(sigs):
    """All-pairs Probability-Jaccard estimate from signatures [n, m] -> [n, n].

    For large n prefer blockwise calls (see ann.py's tiled search).
    """
    s = jnp.asarray(sigs)
    return (s[:, None, :] == s[None, :, :]).mean(axis=-1)
