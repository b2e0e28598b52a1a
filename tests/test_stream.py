"""Streaming count table (count/stream.py) + its merge/aggregate passes
(ops/merge.py) against numpy / collections.Counter oracles."""

import collections
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from kmerutils_tpu.ops import merge as mp
from kmerutils_tpu.count import stream
from kmerutils_tpu.base.sequence import pack_ascii_reads
from kmerutils_tpu.base import kmer as kmer_mod

RNG = np.random.default_rng(42)
COMP = str.maketrans("ACGT", "TGCA")

# Default matrices keep one representative config per op family / regime;
# KMERUTILS_FULL_MATRIX=1 restores the full coverage matrix.
FULL_MATRIX = bool(os.environ.get("KMERUTILS_FULL_MATRIX"))


def _mx(slim, extra):
    return slim + extra if FULL_MATRIX else slim


def _rand_sorted(n, ncmp, narr, max_key=2**32):
    arrs = [RNG.integers(1, max_key, n, dtype=np.uint64).astype(np.uint32)]
    for _ in range(narr - 1):
        arrs.append(RNG.integers(0, 2**32, n, dtype=np.uint64)
                    .astype(np.uint32))
    packed = arrs[0].astype(np.uint64)
    if ncmp == 2:
        packed = (packed << np.uint64(32)) | arrs[1]
    order = np.argsort(packed, kind="stable")
    return [a[order] for a in arrs]


@pytest.mark.parametrize("na,nb,ncmp,narr", _mx([
    (1000, 777, 1, 1),
    (5000, 3000, 2, 2),
    (2048, 0, 1, 2),
], [
    (300, 20000, 2, 4),
]))
def test_merge_sorted_u32(na, nb, ncmp, narr):
    A = _rand_sorted(na, ncmp, narr)
    B = _rand_sorted(nb, ncmp, narr)
    outs = [np.asarray(o) for o in
            mp.merge_sorted_u32(tuple(A), tuple(B), ncmp=ncmp)]

    def packkey(arrs):
        p = arrs[0].astype(np.uint64)
        if ncmp == 2:
            p = (p << np.uint64(32)) | arrs[1]
        return p

    order = np.argsort(np.concatenate([packkey(A), packkey(B)]),
                       kind="stable")
    total = na + nb
    for j in range(narr):
        exp = np.concatenate([A[j], B[j]])[order]
        got = outs[j][:total]
        if j < ncmp:
            assert np.array_equal(exp, got)
        else:
            # ties may reorder whole entries; compare as multisets
            assert np.array_equal(np.sort(exp), np.sort(got))
    assert all(o.shape == (total,) for o in outs)


def test_merge_payload_entries_travel_together():
    # entries (key, cnt | payload) must never mix words across entries
    n = 3000
    key = np.sort(RNG.integers(1, 50, n).astype(np.uint32))  # many dup keys
    cnt = RNG.integers(1, 1000, n).astype(np.uint32)
    pay = key * np.uint32(7) + cnt                           # checkable link
    A = (key, cnt, pay)
    m = 500
    key_b = np.sort(RNG.integers(1, 50, m).astype(np.uint32))
    cnt_b = RNG.integers(1, 1000, m).astype(np.uint32)
    pay_b = key_b * np.uint32(7) + cnt_b
    outs = [np.asarray(o) for o in
            mp.merge_sorted_u32(A, (key_b, cnt_b, pay_b), ncmp=2)]
    live = outs[0] != 0xFFFFFFFF
    assert np.array_equal(outs[2][live],
                          outs[0][live] * np.uint32(7) + outs[1][live])


def _to_persistent(arrs_u32, ncmp, capacity, garbage_tail=False):
    """Raw sorted u32 entry arrays -> the persistent table form
    (count/stream.py layout): flipped cmp words, length ``capacity``.  With
    ``garbage_tail`` the region past the live prefix holds RANDOM values
    (the production state after a compaction) — the ops must never read it
    as data."""
    lp = capacity
    out = []
    for j, x in enumerate(arrs_u32):
        if garbage_tail:
            full = RNG.integers(0, 2**32, lp, dtype=np.uint64) \
                .astype(np.uint32)
        else:
            full = np.full(lp, 0xFFFFFFFF, np.uint32)
        full[:len(x)] = x
        if j < ncmp:
            full ^= np.uint32(0x80000000)
        out.append(jnp.asarray(full.view(np.int32)))
    return tuple(out)


@pytest.mark.parametrize("used,nb,ncmp,narr,capacity", _mx([
    (5000, 3000, 2, 3, 9000),
    (900, 800, 1, 2, 1024),            # past capacity: largest keys drop
    (0, 500, 2, 5, 4000),              # empty table
    (1200, 0, 1, 2, 4000),             # empty batch
], [
    (1000, 777, 1, 2, 5000),
    (300, 2000, 1, 4, 4000),
    (15000, 9000, 1, 2, 30000),
]))
def test_merge_fold_i32(used, nb, ncmp, narr, capacity):
    # keys in [1, 2^32-16): off the all-ones sentinel
    A = _rand_sorted(used, ncmp, narr, max_key=2**32 - 16) if used else \
        [np.zeros(0, np.uint32)] * narr
    B = _rand_sorted(nb, ncmp, narr, max_key=2**32 - 16) if nb else \
        [np.zeros(0, np.uint32)] * narr
    a_in = _to_persistent(A, ncmp, capacity, garbage_tail=True)
    # the batch side travels raw (count/stream.batch_entries), with a
    # dead all-ones tail that must never reach the table
    b_in = tuple(jnp.asarray(np.concatenate(
        [x, np.full(64, 0xFFFFFFFF, np.uint32)])) for x in B)
    outs = mp.merge_fold_i32(a_in, b_in, used, ncmp=ncmp)

    def packkey(arrs):
        p = arrs[0].astype(np.uint64)
        if ncmp == 2:
            p = (p << np.uint64(32)) | arrs[1]
        return p

    order = np.argsort(np.concatenate([packkey(A), packkey(B)]),
                       kind="stable")
    valid = min(used + nb, capacity)          # guaranteed merged prefix
    for j in range(narr):
        got = np.asarray(outs[j])[:valid].view(np.uint32)
        if j < ncmp:
            got = got ^ np.uint32(0x80000000)
            exp = np.concatenate([A[j], B[j]])[order][:valid]
            assert np.array_equal(exp, got)
        else:
            exp = np.concatenate([A[j], B[j]])[order][:valid]
            assert np.array_equal(np.sort(exp), np.sort(got))
    assert all(np.asarray(o).shape == (capacity,) for o in outs)


@pytest.mark.parametrize("n,kw,coords,lo,hi,capacity", _mx([
    (5000, 2, True, 2, 5, 6000),
    (0, 1, False, 1, None, 4000),
    (4096, 1, False, 1, None, 4096),   # used == capacity edge
], [
    (3000, 1, False, 1, None, 4000),
    (3000, 1, True, 1, None, 4000),
]))
def test_aggregate_fold_i32(n, kw, coords, lo, hi, capacity):
    narr = kw + 1 + (2 if coords else 0)
    # duplicate-heavy sorted keys; counts near saturation sometimes
    key = np.sort(RNG.integers(1, max(n // 4, 2), n).astype(np.uint32))
    arrs = [key]
    if kw == 2:
        arrs = [key, RNG.integers(0, 3, n).astype(np.uint32)]
        order = np.argsort((arrs[0].astype(np.uint64) << np.uint64(32))
                           | arrs[1], kind="stable")
        arrs = [a[order] for a in arrs]
    cnt = RNG.integers(1, 10, n).astype(np.uint32)
    cnt[RNG.random(n) < 0.01] = 0xFFFFFFF0          # saturation cases
    arrs.append(cnt)
    if coords:
        arrs.append(RNG.integers(0, 2**32, n, dtype=np.uint64)
                    .astype(np.uint32))
        arrs.append(RNG.integers(0, 2**32, n, dtype=np.uint64)
                    .astype(np.uint32))
    # garbage_tail: the kernel must decide liveness by `used`, not content
    a_in = _to_persistent(arrs, kw, capacity, garbage_tail=True)
    outs, n_live = mp.aggregate_fold_i32(
        tuple(a_in), n, kw=kw, coords=coords, lo=lo, hi=hi)
    n_live = int(n_live)

    # numpy oracle
    packed = arrs[0].astype(np.uint64)
    if kw == 2:
        packed = (packed << np.uint64(32)) | arrs[1]
    exp_rows = []
    if n:
        starts = np.flatnonzero(np.concatenate([[True],
                                                packed[1:] != packed[:-1]]))
        ends = np.concatenate([starts[1:], [n]])
        for s, e in zip(starts, ends):
            tot = min(int(arrs[kw][s:e].astype(np.uint64).sum()),
                      0xFFFFFFFF)
            if tot < lo or (hi is not None and tot > hi):
                continue
            row = [int(a[s]) for a in arrs[:kw]] + [tot]
            if coords:
                pc = ((arrs[kw + 1][s:e].astype(np.uint64) << np.uint64(32))
                      | arrs[kw + 2][s:e]).min()
                row += [int(pc >> np.uint64(32)), int(pc & np.uint64(0xFFFFFFFF))]
            exp_rows.append(row)
    assert n_live == len(exp_rows)
    got = np.stack([np.asarray(o)[:n_live].view(np.uint32)
                    for o in outs]).T if n_live else np.zeros((0, narr))
    for i, row in enumerate(exp_rows):
        g = got[i].copy()
        for j in range(kw):
            g[j] ^= np.uint32(0x80000000)
        assert list(g.astype(np.int64)) == [r & 0xFFFFFFFF for r in row], \
            f"row {i}: {list(g)} != {row}"


def _random_reads(n_reads, lo, hi):
    return ["".join(RNG.choice(list("ACGT"), size=int(n)))
            for n in RNG.integers(lo, hi, n_reads)]


def _oracle_counts(reads, k):
    oracle = collections.Counter()
    first = {}
    for rn, r in enumerate(reads):
        for i in range(len(r) - k + 1):
            s = r[i:i + k]
            rc = s.translate(COMP)[::-1]
            c = min(s, rc)
            oracle[c] += 1
            first.setdefault(c, (rn, i))
    return oracle, first


@pytest.mark.parametrize("k,coords", _mx(
    [(16, True), (21, True)],
    [(16, False), (11, False), (21, False)]))
def test_stream_table_vs_counter(k, coords):
    wide = k > 16
    reads_batches = [_random_reads(8, 60, 400) for _ in range(3)]
    table = stream.StreamCountTable.create(1 << 13, wide=wide, coords=coords)
    offset = 0
    for reads in reads_batches:
        batch = pack_ascii_reads(reads)
        arrs, live = stream.batch_entries(batch, k, offset, coords=coords)
        table = stream.fold(table, arrs, live)
        offset += len(reads)
    keys, counts, rn, ps, dropped = stream.finalize(table)
    assert dropped == 0

    all_reads = [r for b in reads_batches for r in b]
    oracle, first = _oracle_counts(all_reads, k)
    vals = {kmer_mod.kmer_value_from_str(s): (c, first[s])
            for s, c in oracle.items()}
    assert len(keys) == len(vals)
    assert np.all(keys[:-1] < keys[1:])                # ascending distinct
    for key, cnt, r, p in zip(keys, counts, rn, ps):
        exp_c, exp_coord = vals[int(key)]
        assert int(cnt) == exp_c
        if coords:
            assert (int(r), int(p)) == exp_coord


def test_fold_empty_batch_grid_zero():
    """An all-dead batch folded into an EMPTY table must leave it empty
    and exactly usable afterwards."""
    k = 16
    table = stream.StreamCountTable.create(1 << 13, wide=False, coords=False)
    reads = _random_reads(6, 60, 200)
    batch = pack_ascii_reads(reads)
    arrs, live = stream.batch_entries(batch, k, 0, coords=False)
    dead = tuple(jnp.full_like(a, 0xFFFFFFFF) for a in arrs)
    table = stream.fold(table, dead, jnp.zeros_like(live))
    assert int(np.asarray(table.used)) == 0
    table = stream.fold(table, arrs, live)                   # then real data
    keys, counts, _, _, dropped = stream.finalize(table)
    assert dropped == 0
    oracle, _ = _oracle_counts(reads, k)
    assert dict(zip(keys.tolist(), counts.tolist())) == {
        kmer_mod.kmer_value_from_str(s): c for s, c in oracle.items()}


@pytest.mark.parametrize("k,coords,n_batches", _mx(
    [(16, True, 5), (21, True, 6)],
    [(16, False, 4), (11, False, 7)]))
def test_staged_folder_vs_counter(k, coords, n_batches):
    # LSM staging (binary-counter merges of batch runs before table folds)
    # must be invisible in the results: counts exact, coords the global
    # first occurrence, regardless of where the stream ends mid-stage
    wide = k > 16
    reads_batches = [_random_reads(6, 60, 300) for _ in range(n_batches)]
    folder = stream.StagedFolder(
        stream.StreamCountTable.create(1 << 13, wide=wide, coords=coords),
        depth=2)
    offset = 0
    n_folds = 0
    for reads in reads_batches:
        batch = pack_ascii_reads(reads)
        arrs, live = stream.batch_entries(batch, k, offset, coords=coords)
        n_folds += folder.push(arrs, live)
        offset += len(reads)
    assert n_folds == n_batches // 4          # one table fold per 2^depth
    keys, counts, rn, ps, dropped = stream.finalize(folder.flush())
    assert dropped == 0

    all_reads = [r for b in reads_batches for r in b]
    oracle, first = _oracle_counts(all_reads, k)
    vals = {kmer_mod.kmer_value_from_str(s): (c, first[s])
            for s, c in oracle.items()}
    assert len(keys) == len(vals)
    assert np.all(keys[:-1] < keys[1:])
    for key, cnt, r, p in zip(keys, counts, rn, ps):
        exp_c, exp_coord = vals[int(key)]
        assert int(cnt) == exp_c
        if coords:
            assert (int(r), int(p)) == exp_coord


def test_staged_folder_auto_depth():
    t_small = stream.StreamCountTable.create(1 << 13, wide=False,
                                             coords=False)
    assert stream.StagedFolder(t_small).depth == 0
    # capacity thresholds: 6 * 2^d * BATCH_CAP <= cap
    assert stream.StagedFolder(
        dataclasses.replace(t_small, cap=1 << 27)).depth == 1
    assert stream.StagedFolder(
        dataclasses.replace(t_small, cap=1 << 28)).depth == 2


def test_stream_table_min_count_filter():
    k = 16
    reads = _random_reads(6, 100, 300)
    reads.append(reads[0])            # duplicate read => counts >= 2
    batch = pack_ascii_reads(reads)
    table = stream.StreamCountTable.create(1 << 13, wide=False, coords=False)
    arrs, live = stream.batch_entries(batch, k, 0)
    table = stream.fold(table, arrs, live)
    keys2, counts2, _, _, _ = stream.finalize(table, min_count=2)
    oracle, _ = _oracle_counts(reads, k)
    exp = sorted(kmer_mod.kmer_value_from_str(s)
                 for s, c in oracle.items() if c >= 2)
    assert [int(x) for x in keys2] == exp
    assert np.all(counts2 >= 2)


def test_stream_table_overflow_drops_largest():
    k = 11
    reads = _random_reads(6, 200, 400)
    batch = pack_ascii_reads(reads)
    arrs, live = stream.batch_entries(batch, k, 0)
    # big-capacity truth
    big = stream.StreamCountTable.create(1 << 13, wide=False, coords=False)
    big = stream.fold(big, arrs, live)
    keys_all, counts_all, _, _, d0 = stream.finalize(big)
    assert d0 == 0
    # tiny capacity: largest keys dropped, smallest exact
    cap = 512
    small = stream.StreamCountTable.create(cap, wide=False, coords=False)
    small = stream.fold(small, arrs, live)
    keys_s, counts_s, _, _, dropped = stream.finalize(small)
    assert dropped > 0
    n = len(keys_s)
    assert n <= cap
    # the smallest surviving keys match the truth exactly (the last
    # surviving key may carry a partial count at the drop boundary)
    assert np.array_equal(keys_s, keys_all[:n])
    assert np.array_equal(counts_s[:-1], counts_all[:n - 1])


def test_grow_mid_stream():
    # growth is a sentinel-pad: counts and coords must be unaffected by a
    # grow between folds (the CLI grows x8 when occupancy stays high)
    k = 11
    b1 = _random_reads(6, 100, 300)
    b2 = _random_reads(6, 100, 300)
    table = stream.StreamCountTable.create(1 << 12, wide=False, coords=True)
    arrs, live = stream.batch_entries(pack_ascii_reads(b1), k, 0,
                                      coords=True)
    table = stream.fold(table, arrs, live)
    table = stream.grow(table, 1 << 14)
    assert table.capacity == 1 << 14
    arrs, live = stream.batch_entries(pack_ascii_reads(b2), k, len(b1),
                                      coords=True)
    table = stream.fold(table, arrs, live)
    keys, counts, rn, ps, dropped = stream.finalize(table)
    assert dropped == 0
    oracle, first = _oracle_counts(b1 + b2, k)
    vals = {kmer_mod.kmer_value_from_str(s): (c, first[s])
            for s, c in oracle.items()}
    assert len(keys) == len(vals)
    for key, cnt, r, p in zip(keys, counts, rn, ps):
        exp_c, exp_coord = vals[int(key)]
        assert int(cnt) == exp_c and (int(r), int(p)) == exp_coord


@pytest.mark.parametrize("k,n_reads,rl", [
    (8, 40, 400),    # k=8: 4^8 domain, heavy coverage -> tiny gaps ->
    #                  finalize ships u16 DELTAS (cumsum reconstruction)
    (16, 2, 40),     # sparse over 2^32 -> gaps overflow u16 -> raw keys
])
def test_finalize_delta_and_raw_paths(k, n_reads, rl):
    """The adaptive key transfer (u16 deltas vs raw) must be invisible:
    both densities reconstruct exactly against the Counter oracle."""
    reads = _random_reads(n_reads, rl, rl + 1)
    batch = pack_ascii_reads(reads)
    table = stream.StreamCountTable.create(1 << 15, wide=False, coords=True)
    arrs, live = stream.batch_entries(batch, k, 0, coords=True)
    table = stream.fold(table, arrs, live)
    keys, counts, rn, ps, dropped = stream.finalize(table)
    assert dropped == 0
    oracle, first = _oracle_counts(reads, k)
    vals = {kmer_mod.kmer_value_from_str(s): (c, first[s])
            for s, c in oracle.items()}
    assert len(keys) == len(vals)
    assert keys.dtype == np.uint32
    assert np.all(keys[:-1] < keys[1:])
    for key, cnt, r, p in zip(keys, counts, rn, ps):
        exp_c, exp_coord = vals[int(key)]
        assert int(cnt) == exp_c and (int(r), int(p)) == exp_coord
    if k == 8:    # confirm this parametrization really is the delta regime
        assert int(np.max(np.diff(keys))) < (1 << 16)
    else:
        assert int(np.max(np.diff(keys))) >= (1 << 16)


@pytest.mark.parametrize("wide,n,holes", [
    (False, 10_000, [0, 3_000, 3_001, 9_999]),  # adjacent + first + last
    (False, 5 * 1024, []),                      # clean, no exceptions
    (True, 7_777, [0, 5_000]),                  # u64 keys, huge gaps
    (False, 100, [50]),                         # tiny set
])
def test_decode_delta_keys_exceptions(wide, n, holes):
    """_decode_delta_keys against crafted key sets with oversized gaps
    (the canonical key space's structural holes): the (index, gap >> 16)
    exception list must rebuild the exact key sequence via one cumsum."""
    W = np.uint64 if wide else np.uint32
    gaps = RNG.integers(1, 200, n).astype(np.uint64)
    for h in holes:
        hi = 40 if wide else 20      # u64 exercises >32-bit gap highs
        gaps[h] = RNG.integers(1 << 16, 1 << hi)
    keys = np.cumsum(gaps).astype(W)
    delta = np.diff(keys, prepend=keys.dtype.type(0))
    d16 = delta.astype(np.uint16)
    exc_pos = np.flatnonzero(delta >= (1 << 16))
    exc_idx = np.zeros(stream._EXC_CAP, np.int32)
    exc_hi = np.zeros(stream._EXC_CAP, W)
    exc_idx[: exc_pos.size] = exc_pos
    exc_hi[: exc_pos.size] = delta[exc_pos] >> W(16)
    got = stream._decode_delta_keys(d16, exc_idx, exc_hi, wide, n,
                                    int(exc_pos.size))
    np.testing.assert_array_equal(got, keys)
    assert got.dtype == W
