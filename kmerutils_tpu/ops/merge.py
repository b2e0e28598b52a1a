"""Sorted-run merge and run aggregation for the streaming count table.

Plain ``jax.numpy``/``lax``: every operation here is a bandwidth-bound pass
that XLA compiles as it stands (a binary search per B entry, cumsums,
gathers, one segmented scan and sorted scatters of unique indices — no
atomics).

Array model: an *entry* spans several parallel 1-D arrays.  The first
``ncmp`` (1 or 2) arrays are the compare words, lexicographic and unsigned
(64-bit keys travel as (hi, lo) u32 pairs); the rest ride as payloads.

Merging is by ranks (stable, A first on ties).  For every B entry ``j``,
``r_j = #{a <= b_j}`` is one binary search, so ``b_j`` lands at output
position ``j + r_j``.  Marking those positions and taking one cumsum tells
every output position whether it comes from B and from which index of A or
B; the outputs are then gathers along nearly sequential indices.

The streaming table (count/stream.py) keeps its entries as int32 words with
the compare words sign-flipped (``x ^ 0x80000000``) and only the prefix
``[0, used)`` meaningful; :func:`merge_fold_i32` and
:func:`aggregate_fold_i32` work in that layout.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32
U64 = jnp.uint64
_FLIP = np.uint32(0x80000000)


def _flip(x):
    """u32 -> sign-flipped i32 (signed order == unsigned order)."""
    return jax.lax.bitcast_convert_type(jnp.asarray(x, U32) ^ _FLIP, I32)


def _unflip(x):
    return jax.lax.bitcast_convert_type(x, U32) ^ _FLIP


def _packed_key(words, ncmp: int):
    """One comparable key per entry: the u32 word, or hi << 32 | lo."""
    if ncmp == 1:
        return words[0]
    return (words[0].astype(U64) << U64(32)) | words[1].astype(U64)


def _merge_plan(a_key, b_key, out_len: int):
    """(from_b, ib, ia) for each of ``out_len`` output positions of the
    stable merge of ascending ``a_key`` and ``b_key``: whether the position
    takes a B entry, and the source index in B and in A.  Entries whose
    merged position is ``>= out_len`` are dropped."""
    nb = b_key.shape[0]
    # unrolled: XLA fuses the ~log2(len_a) dependent gathers into one
    # kernel instead of a while loop that copies its carry every level
    r = jnp.searchsorted(a_key, b_key, side="right",
                         method="scan_unrolled").astype(I32)
    pos_b = jnp.arange(nb, dtype=I32) + r
    from_b = jnp.zeros(out_len, bool).at[pos_b].set(
        True, mode="drop", indices_are_sorted=True, unique_indices=True)
    cb = jnp.cumsum(from_b, dtype=I32)
    ib = jnp.maximum(cb - 1, 0)
    ia = jnp.arange(out_len, dtype=I32) - cb
    return from_b, ib, ia


def _gather_merged(a_arrs, b_arrs, plan):
    from_b, ib, ia = plan
    return tuple(jnp.where(from_b, jnp.take(y, ib, mode="clip"),
                           jnp.take(x, ia, mode="clip"))
                 for x, y in zip(a_arrs, b_arrs))


@functools.partial(jax.jit, static_argnames=("ncmp",))
def merge_sorted_u32(a_arrs, b_arrs, ncmp: int = 1):
    """Merge sorted A entries with sorted B entries (stable, A first on
    ties).

    a_arrs, b_arrs: tuples of 1-D uint32 arrays (equal lengths within each
    side), ascending by the first ``ncmp`` words; all-ones sentinel tails
    are entries like any other and sort last.  Returns a tuple of uint32
    arrays of length ``len_a + len_b``.
    """
    assert 1 <= ncmp <= 2 and len(a_arrs) == len(b_arrs)
    a = [jnp.asarray(x, U32) for x in a_arrs]
    b = [jnp.asarray(x, U32) for x in b_arrs]
    na, nb = a[0].shape[0], b[0].shape[0]
    if na == 0 or nb == 0:
        return tuple(b if na == 0 else a)
    plan = _merge_plan(_packed_key(a, ncmp), _packed_key(b, ncmp), na + nb)
    return _gather_merged(a, b, plan)


@functools.partial(jax.jit, static_argnames=("ncmp",))
def merge_fold_i32(a_arrs, b_arrs, used, *, ncmp: int):
    """Fold sorted batch entries into a table's live prefix.

    a_arrs: int32 table arrays [L]; the first ``ncmp`` are sign-flipped
      compare words, ascending over ``[0, used)``; positions ``>= used``
      are never read as data.
    b_arrs: uint32 batch arrays [nb] in raw entry order (ascending, dead
      entries all-ones at the tail — :func:`count.stream.batch_entries`).
    used: traced live length of the table.

    Returns int32 arrays [L] in the table's layout: positions
    ``[0, min(used + live_b, L))`` hold the merged entries, the rest is
    unspecified.  Merged entries past ``L`` (the largest keys) are dropped;
    the caller counts them as ``max(used + live_b - L, 0)``.
    """
    narr = len(a_arrs)
    assert len(b_arrs) == narr and 1 <= ncmp <= 2
    L = a_arrs[0].shape[0]
    if b_arrs[0].shape[0] == 0:
        return tuple(a_arrs)
    live = jnp.arange(L, dtype=I32) < jnp.asarray(used, I32)
    a_key = _packed_key([_unflip(w) for w in a_arrs[:ncmp]], ncmp)
    a_key = jnp.where(live, a_key, np.array(-1).astype(a_key.dtype))
    b = [jnp.asarray(x, U32) for x in b_arrs]
    plan = _merge_plan(a_key, _packed_key(b, ncmp), L)
    b_i32 = [_flip(y) if j < ncmp else jax.lax.bitcast_convert_type(y, I32)
             for j, y in enumerate(b)]
    return _gather_merged(a_arrs, b_i32, plan)


def _scatter_rows(dest, vals, n: int):
    """out[dest[i]] = vals[i] for dest[i] < n (unique ascending targets)."""
    return jnp.zeros(n, vals.dtype).at[dest].set(
        vals, mode="drop", indices_are_sorted=True, unique_indices=True)


def _segmented_min(head, x):
    """Inclusive prefix minimum of x restarting at every head."""
    def comb(a, b):
        return a[0] | b[0], jnp.where(b[0], b[1], jnp.minimum(a[1], b[1]))
    return jax.lax.associative_scan(comb, (head, x))[1]


@functools.partial(jax.jit, static_argnames=("kw", "coords", "lo", "hi"))
def aggregate_fold_i32(arrs, used, *, kw: int, coords: bool,
                       lo: int = 1, hi: int | None = None):
    """Aggregate duplicate-key runs of a table's live prefix, filter by
    count, and compact.

    arrs: int32 table arrays [L] — ``kw`` sign-flipped key words, the count
    word, then two coordinate words when ``coords`` — ascending by key over
    ``[0, used)``.  Returns (arrs', n_live) in the same layout: one entry
    per distinct key with ``lo <= count <= hi`` in ``[0, n_live)``, counts
    summed with saturation at 2^32-1, coordinates the lexicographic minimum
    (hi, lo) of the run; positions ``>= n_live`` are unspecified.

    Runs are contiguous, so a run's count is a difference of one u64
    cumsum at its ends and its coordinate the end value of a segmented
    prefix minimum: no scatter-add or scatter-min (their atomics cost ~4x
    the whole pass on the GPU).
    """
    narr = len(arrs)
    assert narr == kw + 1 + (2 if coords else 0)
    L = arrs[0].shape[0]
    idx = jnp.arange(L, dtype=I32)
    used = jnp.asarray(used, I32)
    live = idx < used
    if L > 1:
        differs = arrs[0][1:] != arrs[0][:-1]
        for w in arrs[1:kw]:
            differs = differs | (w[1:] != w[:-1])
        head = live & jnp.concatenate([jnp.ones(1, bool), differs])
    else:
        head = live
    run = jnp.cumsum(head, dtype=I32) - 1
    n_runs = jnp.sum(head, dtype=I32)
    # first and last entry of run r (garbage for r >= n_runs)
    start = _scatter_rows(jnp.where(head, run, L), idx, L)
    nxt = jnp.concatenate([start[1:], jnp.full(1, L, I32)])
    end = jnp.where(idx + 1 < n_runs, nxt, used) - 1
    cnt = jax.lax.bitcast_convert_type(arrs[kw], U32).astype(U64)
    csum = jnp.cumsum(jnp.where(live, cnt, U64(0)))
    before = jnp.where(start > 0, jnp.take(csum, start - 1, mode="clip"),
                       U64(0))
    tot = jnp.take(csum, end, mode="clip") - before
    tot = jnp.minimum(tot, U64(0xFFFFFFFF)).astype(U32)
    vals = [jnp.take(w, start, mode="clip") for w in arrs[:kw]]
    vals.append(jax.lax.bitcast_convert_type(tot, I32))
    if coords:
        c = ((jax.lax.bitcast_convert_type(arrs[kw + 1], U32).astype(U64)
              << U64(32))
             | jax.lax.bitcast_convert_type(arrs[kw + 2], U32).astype(U64))
        cmin = jnp.take(_segmented_min(head, c), end, mode="clip")
        vals.append(jax.lax.bitcast_convert_type(
            (cmin >> U64(32)).astype(U32), I32))
        vals.append(jax.lax.bitcast_convert_type(cmin.astype(U32), I32))
    if lo <= 1 and hi is None:
        return tuple(vals), n_runs
    keep = idx < n_runs
    if lo > 1:
        keep = keep & (tot >= U32(lo))
    if hi is not None:
        keep = keep & (tot <= U32(hi))
    dest = jnp.where(keep, jnp.cumsum(keep, dtype=I32) - 1, L)
    return (tuple(_scatter_rows(dest, v, L) for v in vals),
            jnp.sum(keep, dtype=I32))
