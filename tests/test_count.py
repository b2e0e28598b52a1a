"""Counting tests — exact counts vs a Python dict oracle (the reference's
statistical counting test strategy, kmercount.rs:1523-1621, made exact)."""

import collections

import numpy as np

from kmerutils_tpu.base.sequence import pack_ascii_reads
from kmerutils_tpu.base import kmer
from kmerutils_tpu.count import exact, filters, dispatch
from kmerutils_tpu.ops import rng as krng

SEQ80 = ("TCAAAGGGAAACATTCAAAATCAGTATGCGCCCGTTCAGTTACGTATTGCTCTCGCT"
         "AATGAGATGGGCTGGGTACAGAG")


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


class TestExactCount:
    def test_count_small(self, rng):
        reads = [SEQ80, SEQ80[3:60], "ACGTACGTACGT",
                 "".join(rng.choice(list("ACGT"), size=200))]
        k = 3
        kc = exact.count_batch(pack_ascii_reads(reads), k)
        keys, counts = exact.compact(kc)
        want = oracle_counts(reads, k)
        assert dict(zip(keys.tolist(), counts.tolist())) == dict(want)
        assert int(kc.n_distinct) == len(want)
        assert int(kc.n_unique) == sum(1 for v in want.values() if v == 1)

    def test_count_k16_and_k20(self, rng):
        reads = ["".join(rng.choice(list("ACGT"), size=150)) for _ in range(5)]
        # force duplicates across reads
        reads.append(reads[0])
        for k in (16, 20):
            kc = exact.count_batch(pack_ascii_reads(reads), k)
            keys, counts = exact.compact(kc)
            want = oracle_counts(reads, k)
            assert dict(zip(keys.tolist(), counts.tolist())) == dict(want)

    def test_unique_coords(self):
        reads = ["ACGTACGTAA", "TTTTACGTAC"]
        k = 5
        keys, rn, ps, n_uniq = exact.unique_kmer_coords(pack_ascii_reads(reads), k)
        keys, rn, ps = exact.compact_unique(keys, rn, ps)
        want = oracle_counts(reads, k)
        uniq_vals = {v for v, c in want.items() if c == 1}
        assert len(keys) == int(n_uniq)
        got = {int(v) for v in keys}
        assert got == uniq_vals
        # each coordinate must point at an occurrence of that canonical kmer
        for v, r, p in zip(keys, rn, ps):
            s = reads[int(r)][int(p) : int(p) + k]
            can = min(kmer.kmer_value_from_str(s),
                      kmer.kmer_value_from_str(revcomp_str(s)))
            assert can == int(v)

    def test_multiplicity_per_slot(self):
        reads = ["ACGTACGTACGTAAAA"]
        k = 4
        mult, valid = exact.multiplicity_per_slot(pack_ascii_reads(reads), k)
        mult = np.asarray(mult)[0]
        want = oracle_counts(reads, k)
        s = reads[0]
        for p in range(len(s) - k + 1):
            sub = s[p : p + k]
            can = min(kmer.kmer_value_from_str(sub),
                      kmer.kmer_value_from_str(revcomp_str(sub)))
            assert mult[p] == want[can]

    def test_merge_counts_host(self, rng):
        reads1 = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(3)]
        reads2 = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(3)]
        k = 7
        kc1 = exact.count_batch(pack_ascii_reads(reads1), k)
        kc2 = exact.count_batch(pack_ascii_reads(reads2), k)
        keys, counts = exact.merge_counts_host([exact.compact(kc1), exact.compact(kc2)])
        want = oracle_counts(reads1 + reads2, k)
        assert dict(zip(keys.tolist(), counts.tolist())) == dict(want)


class TestFilters:
    def test_bloom(self, rng):
        bf = filters.BloomFilter.create(log2_slots=14, nb_hash=4)
        keys = rng.integers(0, 1 << 62, size=500, dtype=np.uint64)
        bf = bf.insert(keys)
        assert bool(np.asarray(bf.contains(keys)).all())
        other = rng.integers(1 << 62, 1 << 63, size=2000, dtype=np.uint64)
        fpr = float(np.asarray(bf.contains(other)).mean())
        assert fpr < 0.05

    def test_counting_bloom(self, rng):
        cb = filters.CountingBloom.create(log2_slots=14, nb_hash=4)
        keys = rng.integers(0, 1 << 62, size=300, dtype=np.uint64)
        cb = cb.insert(keys).insert(keys[:100])
        est = np.asarray(cb.estimate_count(keys))
        # CBF never under-counts
        assert (est[:100] >= 2).all() and (est >= 1).all()
        assert (est <= 4).all()  # gross over-count would indicate a bug

    def test_bloom_union(self, rng):
        a = filters.BloomFilter.create(10, 3)
        b = filters.BloomFilter.create(10, 3)
        k1 = rng.integers(0, 1 << 60, size=50, dtype=np.uint64)
        k2 = rng.integers(0, 1 << 60, size=50, dtype=np.uint64)
        u = a.insert(k1).union(b.insert(k2))
        assert bool(np.asarray(u.contains(np.concatenate([k1, k2]))).all())


class TestRngAndDispatch:
    def test_wang32_invertible(self, rng):
        x = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
        h = np.asarray(krng.wang_hash32(x))
        back = np.asarray(krng.wang_hash32_inv(h))
        assert (back == x).all()

    def test_wang64_invertible(self, rng):
        x = rng.integers(0, 1 << 63, size=1000, dtype=np.uint64)
        h = np.asarray(krng.wang_hash64(x))
        back = np.asarray(krng.wang_hash64_inv(h))
        assert (back == x).all()

    def test_dispatch_balance(self, rng):
        vals = rng.integers(0, 1 << 28, size=20000, dtype=np.uint32)
        for n in (4, 8):
            sh = np.asarray(dispatch.dispatch_u32(vals, n))
            frac = np.bincount(sh, minlength=n) / vals.size
            assert abs(frac - 1 / n).max() < 0.02

    def test_uniform01_range(self):
        bits = np.asarray(krng.splitmix64(np.arange(1000, dtype=np.uint64)))
        u = np.asarray(krng.uniform01_from_bits(bits))
        assert (u > 0).all() and (u <= 1).all()
        assert abs(u.mean() - 0.5) < 0.05


def test_count_batch_nthash(rng):
    from kmerutils_tpu.base import nthash
    reads = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(4)]
    reads.append(reads[0])
    k = 9
    batch = pack_ascii_reads(reads)
    kc = exact.count_batch_nthash(batch, k)
    keys, counts = exact.compact(kc)
    # oracle: canonical nthash per position via the scalar golden model
    c = collections.Counter()
    for s in reads:
        codes = np.frombuffer(s.encode(), dtype=np.uint8)
        from kmerutils_tpu.base.alphabet import encode_2b
        cc = encode_2b(codes)
        for p in range(len(s) - k + 1):
            f = nthash.nthash_init_ref(cc[p : p + k])
            r = nthash.nthash_rcomp_init_ref(cc[p : p + k])
            c[min(f, r)] += 1
    assert dict(zip(keys.tolist(), counts.tolist())) == dict(c)


# The round-1 DeviceCountTable sort-fold engine was retired;
# streaming accumulation is covered by tests/test_stream.py and the sharded
# path by tests/test_parallel.py::TestShardedStreamCounter.


