"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import collections
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kmerutils_tpu.base.sequence import pack_ascii_reads
from kmerutils_tpu.base import kmer
from kmerutils_tpu.count import exact
from kmerutils_tpu.parallel import mesh as kmesh, collective
from kmerutils_tpu.sketch.setsketch import SetSketchParams
from kmerutils_tpu.sketch import setsketch


FULL_MATRIX = bool(os.environ.get("KMERUTILS_FULL_MATRIX"))


def _mx(slim, extra):
    """Slim default (one config per regime); KMERUTILS_FULL_MATRIX=1
    restores the full matrix."""
    return slim + extra if FULL_MATRIX else slim


def revcomp_str(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def oracle_counts(reads, k):
    c = collections.Counter()
    for s in reads:
        for p in range(len(s) - k + 1):
            sub = s[p : p + k]
            c[min(kmer.kmer_value_from_str(sub),
                  kmer.kmer_value_from_str(revcomp_str(sub)))] += 1
    return c


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return kmesh.make_mesh(8)


class TestShardedCount:
    def test_matches_oracle(self, rng, mesh8):
        reads = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(16)]
        reads = reads + reads[:8]  # cross-device duplicate kmers
        batch = pack_ascii_reads(reads)
        k = 9
        keys, counts, dropped, nd, nu = collective.sharded_count(batch, k, mesh8)
        keys, counts = np.asarray(keys), np.asarray(counts)
        assert int(np.asarray(dropped).sum()) == 0
        got = {}
        for d in range(keys.shape[0]):
            live = counts[d] > 0
            assert live.sum() == int(np.asarray(nd)[d])
            for kk, cc in zip(keys[d][live], counts[d][live]):
                assert kk not in got  # shards disjoint
                got[int(kk)] = int(cc)
        want = oracle_counts(reads, k)
        assert got == dict(want)

    def test_shard_ownership(self, rng, mesh8):
        from kmerutils_tpu.count import dispatch
        reads = ["".join(rng.choice(list("ACGT"), size=150)) for _ in range(8)]
        batch = pack_ascii_reads(reads)
        k = 9
        keys, counts, dropped, nd, nu = collective.sharded_count(batch, k, mesh8)
        keys = np.asarray(keys)
        counts = np.asarray(counts)
        for d in range(8):
            live = keys[d][counts[d] > 0]
            if live.size:
                sid = np.asarray(dispatch.dispatch(jnp.asarray(live), 8, k))
                assert (sid == d).all()


class TestShardedSketch:
    def test_setsketch_collection_merge(self, rng, mesh8):
        sp = SetSketchParams(m=256)
        items = rng.integers(1, 1 << 60, size=(16, 64), dtype=np.uint64)
        valid = np.ones((16, 64), bool)
        merged = collective.sharded_setsketch_collection(
            jnp.asarray(items), jnp.asarray(valid), sp, mesh8)
        # must equal the single-device sketch of everything
        all_regs = setsketch.setsketch_signatures(
            items.reshape(1, -1), valid.reshape(1, -1), sp)[0]
        assert (np.asarray(merged) == np.asarray(all_regs)).all()

    def test_data_parallel_sketch(self, rng, mesh8):
        from kmerutils_tpu.sketch import superminhash
        items = rng.integers(1, 1 << 60, size=(16, 32), dtype=np.uint64)
        valid = np.ones((16, 32), bool)
        fn = collective.data_parallel_sketch(
            lambda it, va: superminhash.superminhash2(it, va, 64)[0], mesh8)
        sigs = np.asarray(fn(jnp.asarray(items), jnp.asarray(valid)))
        ref = np.asarray(superminhash.superminhash2(items, valid, 64)[0])
        assert (sigs == ref).all()


class TestRedundantShardedCount:
    def test_matches_oracle(self, rng, mesh8):
        reads = ["".join(rng.choice(list("ACGT"), size=180)) for _ in range(12)]
        reads += reads[:4]
        batch = pack_ascii_reads(reads)
        k = 9
        keys, counts, nd, nu = collective.sharded_count_redundant(batch, k, mesh8)
        keys, counts = np.asarray(keys), np.asarray(counts)
        got = {}
        for d in range(keys.shape[0]):
            live = counts[d] > 0
            assert live.sum() == int(np.asarray(nd)[d])
            for kk, cc in zip(keys[d][live], counts[d][live]):
                assert kk not in got
                got[int(kk)] = int(cc)
        assert got == dict(oracle_counts(reads, k))


def first_occurrences(reads, k):
    first = {}
    for r, s in enumerate(reads):
        for p in range(len(s) - k + 1):
            sub = s[p : p + k]
            can = min(kmer.kmer_value_from_str(sub),
                      kmer.kmer_value_from_str(revcomp_str(sub)))
            first.setdefault(can, (r, p))
    return first


def _sharded_batch(reads, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kmerutils_tpu.base.sequence import ReadBatch
    sh = NamedSharding(mesh, P(kmesh.READS_AXIS))
    b = pack_ascii_reads(reads)
    return ReadBatch(words=jax.device_put(np.asarray(b.words), sh),
                     lengths=jax.device_put(np.asarray(b.lengths), sh))


class TestShardedStreamCounter:
    """The production multi-chip streaming engine (parallel/stream.py):
    LSM staging, growth ladder, spill — oracle-verified on the 8-dev mesh."""

    def test_program_cache_shared_across_instances(self, mesh8):
        # two counters on the same mesh MUST reuse the same jitted
        # executables (a second instance used to re-trace and re-compile
        # the whole family — 29 s of duplicated compile CPU measured on
        # the 2-process CPU harness)
        from kmerutils_tpu.count import stream
        from kmerutils_tpu.parallel import stream as pstream
        a = pstream.ShardedStreamCounter(mesh8, 1 << 12, depth=0)
        b = pstream.ShardedStreamCounter(mesh8, 1 << 12, depth=0)
        assert a._get_fold(128) is b._get_fold(128)
        assert a._get_merge(2) is b._get_merge(2)
        assert (pstream.make_hint_reduce(mesh8)
                is pstream.make_hint_reduce(mesh8))
        assert (pstream.make_exchange(mesh8, 16, False, False)
                is pstream.make_exchange(mesh8, 16, False, False))
        # distinct static params => distinct programs
        wide_t = stream.StreamCountTable.create(1 << 12, wide=True,
                                                coords=False)
        assert (pstream.make_fold(mesh8, wide_t)
                is not a._get_fold(128))

    @pytest.mark.parametrize("k,depth", _mx([(21, 1)], [(13, 2)]))
    def test_staged_matches_oracle(self, rng, mesh8, k, depth):
        from kmerutils_tpu.parallel import stream as pstream
        all_reads = []
        ctr = pstream.ShardedStreamCounter(mesh8, 1 << 12, wide=k > 16,
                                           coords=True, depth=depth)
        offset = 0
        # enough batches that staging merges runs AND flushes a remainder
        for b in range((1 << depth) + 1):
            reads = ["".join(rng.choice(list("ACGT"), size=160))
                     for _ in range(16)]
            if b:
                reads[:4] = all_reads[:4]  # cross-batch duplicates
            all_reads.extend(reads)
            ctr.update(_sharded_batch(reads, mesh8), k,
                       read_num_offset=offset)
            offset += len(reads)
        keys, counts, rn, ps, dropped = ctr.finalize()
        assert dropped == 0
        assert ctr.dropped_in_transit == 0
        assert dict(zip(keys.tolist(), counts.tolist())) == \
            dict(oracle_counts(all_reads, k))
        first = first_occurrences(all_reads, k)
        for v, r_, p_ in zip(keys.tolist(), rn.tolist(), ps.tolist()):
            assert first[v] == (r_, p_), v

    def test_in_transit_drop_accounting(self, rng, mesh8):
        # deliberately tiny shard_cap_factor: the all_to_all buckets
        # overflow and the psum-reduced global drop count must equal
        # generated - received exactly (kmercount.rs:382-420 overflow
        # semantics made observable)
        from kmerutils_tpu.parallel import stream as pstream
        ctr = pstream.ShardedStreamCounter(mesh8, 1 << 12, coords=False,
                                           depth=0, shard_cap_factor=0.1)
        k = 13
        reads = ["".join(rng.choice(list("ACGT"), size=2048))
                 for _ in range(8)]
        ctr.update(_sharded_batch(reads, mesh8), k)
        local = ctr.finalize_local()
        assert isinstance(ctr.dropped_in_transit, int)
        assert ctr.dropped_in_transit > 0
        generated = sum(len(s) - k + 1 for s in reads)
        received = sum(int(v[1].sum()) for v in local.values())
        assert ctr.dropped_in_transit == generated - received

    def test_hint_every_sparse_sampling(self, rng, mesh8):
        # pre-sized capacity + hint_every>1 (the scaling-tool
        # configuration): the hint reduce fires sparsely and counts
        # stay oracle-exact
        from kmerutils_tpu.parallel import stream as pstream
        all_reads = []
        ctr = pstream.ShardedStreamCounter(mesh8, 1 << 12, coords=False,
                                           depth=0, hint_every=3)
        for b in range(5):
            reads = ["".join(rng.choice(list("ACGT"), size=120))
                     for _ in range(16)]
            all_reads.extend(reads)
            ctr.update(_sharded_batch(reads, mesh8), 13,
                       read_num_offset=b * 16)
        keys, counts, _, _, dropped = ctr.finalize()
        assert dropped == 0
        assert dict(zip(keys.tolist(), counts.tolist())) == \
            dict(oracle_counts(all_reads, 13))

    def test_growth_ladder(self, rng, mesh8):
        # tables start too small for the stream: the replicated grow hint
        # must fire (lag-1) and capacity must step up without losing counts
        from kmerutils_tpu.parallel import stream as pstream
        k = 13
        # per-device batch_live ~ 16*188/8 = 376 entries; S=2048 gives the
        # lag-1 hint its 3-fold post-compact slack before any fold can drop
        ctr = pstream.ShardedStreamCounter(
            mesh8, 1 << 11, wide=False, coords=False,
            cap_max_per_device=1 << 14, depth=0)
        all_reads = []
        offset = 0
        for b in range(8):
            reads = ["".join(rng.choice(list("ACGT"), size=200))
                     for _ in range(16)]
            all_reads.extend(reads)
            ctr.update(_sharded_batch(reads, mesh8), k,
                       read_num_offset=offset)
            offset += len(reads)
        assert ctr.table.cap > (1 << 11), "growth ladder never fired"
        keys, counts, _, _, dropped = ctr.finalize()
        assert dropped == 0
        assert dict(zip(keys.tolist(), counts.tolist())) == \
            dict(oracle_counts(all_reads, k))

    def test_spill_epochs(self, rng, mesh8, tmp_path):
        # ladder topped out (cap_max == cap): the counter must spill shards
        # to disk segments and the k-way merge must restore exact counts
        from kmerutils_tpu.parallel import stream as pstream
        k = 13
        ctr = pstream.ShardedStreamCounter(
            mesh8, 1 << 11, wide=False, coords=True,
            cap_max_per_device=1 << 11, depth=0, spill=True,
            spill_dir=str(tmp_path))
        all_reads = []
        offset = 0
        for b in range(10):
            reads = ["".join(rng.choice(list("ACGT"), size=200))
                     for _ in range(16)]
            all_reads.extend(reads)
            ctr.update(_sharded_batch(reads, mesh8), k,
                       read_num_offset=offset)
            offset += len(reads)
        keys, counts, rn, ps, dropped = ctr.finalize()
        assert ctr.spill_stores, "spill never triggered"
        assert dropped == 0
        assert dict(zip(keys.tolist(), counts.tolist())) == \
            dict(oracle_counts(all_reads, k))
        first = first_occurrences(all_reads, k)
        for v, r_, p_ in zip(keys.tolist(), rn.tolist(), ps.tolist()):
            assert first[v] == (r_, p_), v
        ctr.close()


class TestShardedStream:
    @pytest.mark.parametrize("k,coords", _mx([(21, True)],
                                             [(13, False), (13, True)]))
    def test_matches_oracle_across_batches(self, rng, mesh8, k, coords):
        # multi-device streaming through the merge-fold tables: two
        # sequential batches, per-shard disjoint tables, host union ==
        # Counter oracle (+ first-occurrence coords)
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh8, P(kmesh.READS_AXIS))
        batches = []
        for _ in range(2):
            reads = ["".join(rng.choice(list("ACGT"), size=160))
                     for _ in range(16)]
            b = pack_ascii_reads(reads)
            from kmerutils_tpu.base.sequence import ReadBatch
            batches.append((reads, ReadBatch(
                words=jax.device_put(np.asarray(b.words), sh),
                lengths=jax.device_put(np.asarray(b.lengths), sh))))

        table = collective.sharded_stream_create(1 << 12, mesh8,
                                                 wide=k > 16, coords=coords)
        offset = 0
        for reads, gb in batches:
            table, dropped = collective.sharded_stream_update(
                table, gb, k, mesh8, read_num_offset=offset)
            assert int(np.asarray(dropped).sum()) == 0
            offset += len(reads)
        keys, counts, rn, ps, dropped = collective.sharded_stream_finalize(
            table, mesh8)
        assert dropped == 0

        all_reads = [r for reads, _ in batches for r in reads]
        want = oracle_counts(all_reads, k)
        got = dict(zip(keys.tolist(), counts.tolist()))
        assert got == dict(want)
        if coords:
            first = {}
            for i, r in enumerate(all_reads):
                for p in range(len(r) - k + 1):
                    sub = r[p:p + k]
                    v = min(kmer.kmer_value_from_str(sub),
                            kmer.kmer_value_from_str(revcomp_str(sub)))
                    first.setdefault(v, (i, p))
            for v, r_, p_ in zip(keys.tolist(), rn.tolist(), ps.tolist()):
                assert first[v] == (r_, p_), v


class TestShardedBloom:
    def test_matches_single_device_at_size(self, rng, mesh8):
        """sharded_bloom_insert at a realistic-ish size (1M keys over the
        8-device mesh): the pmax-unioned replicated slots must be
        IDENTICAL to a single-device insert of the same keys (probe
        indices are deterministic; max-union is exact, the mergeability of
        kmercount.rs:810-814), every inserted key must test positive, and
        the fill fraction must match the Bloom expectation (balance)."""
        from kmerutils_tpu.count import filters
        from kmerutils_tpu.count.exact import SENTINEL64

        n, log2s, nh = 1 << 20, 24, 4
        keys = rng.integers(0, 2**63, size=n, dtype=np.uint64)
        # pad one sentinel per shard tail (the masked-lane path)
        keys_sh = keys.reshape(8, -1)
        keys_sh = np.concatenate(
            [keys_sh, np.full((8, 1), SENTINEL64, np.uint64)], axis=1)
        slots = jnp.zeros(1 << log2s, jnp.uint8)
        out = collective.sharded_bloom_insert(
            slots, jnp.asarray(keys_sh.ravel()), nh, log2s, mesh8)

        ref = filters.BloomFilter.create(log2s, nh).insert(
            jnp.asarray(keys))
        np.testing.assert_array_equal(np.asarray(out),
                                      np.asarray(ref.slots))

        bf = filters.BloomFilter(slots=out, nb_hash=nh, log2_slots=log2s)
        probe = jnp.asarray(keys[:: max(n // 4096, 1)])
        assert bool(np.asarray(bf.contains(probe)).all())
        # expected fill: 1 - (1 - 1/S)^(n*nh)
        exp = 1.0 - (1.0 - 1.0 / (1 << log2s)) ** (n * nh)
        got = float(np.asarray(out, np.float64).mean())
        assert abs(got - exp) < 0.01, (got, exp)
