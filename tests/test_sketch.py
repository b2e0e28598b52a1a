"""Sketching accuracy tests — known-overlap constructions with analytic
Jaccard and tolerance assertions, mirroring the reference's strategy
(seqsketchjaccard.rs:740-1005: seq vs its half, seq vs reverse complement,
tolerance >= 0.75 * theoretical; setsketchert.rs:1074-1222: |dist-0.5|<0.1)."""

import numpy as np
import pytest

from kmerutils_tpu.base.sequence import pack_ascii_reads
from kmerutils_tpu.sketch import probminhash, superminhash, densminhash, setsketch, minhash
from kmerutils_tpu.sketch.jaccard import Sketcher, jaccard_one_vs_many, hashed_weighted_kmers
from kmerutils_tpu.sketch.params import SeqSketcherParams, SketchAlgo, DataType
from kmerutils_tpu.sketch.setsketch import SetSketchParams

K = 11
M = 256
LEN = 2000


def make_pair(rng):
    """(full, half): J approx (LEN/2 - K + 1)/(LEN - K + 1) ~ 0.5."""
    s = "".join(rng.choice(list("ACGT"), size=LEN))
    return s, s[: LEN // 2]


def revcomp_str(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def theo_jaccard(full, half):
    def canon_set(s):
        out = set()
        for p in range(len(s) - K + 1):
            sub = s[p : p + K]
            out.add(min(sub, revcomp_str(sub)))
        return out
    a, b = canon_set(full), canon_set(half)
    return len(a & b) / len(a | b)


@pytest.fixture(scope="module")
def pair(rng):
    full, half = make_pair(rng)
    return full, half, theo_jaccard(full, half)


def algo_jaccard(algo, pair, **kw):
    full, half, theo = pair
    params = SeqSketcherParams(kmer_size=K, sketch_size=M, algo=algo,
                               data_t=DataType.DNA)
    batch = pack_ascii_reads([full, half, revcomp_str(full)])
    sk = Sketcher(params=params, **kw)
    sigs = sk.sketch_batch(batch)
    j_half = float(sk.jaccard(sigs[0], sigs[1]))
    j_rc = float(sk.jaccard(sigs[0], sigs[2]))
    return j_half, j_rc, theo


def _tournament_oracle(items, winv, valid, m, seed):
    """numpy transcription of probminhash._tournament's draw: slot
    constants from splitmix64, the u32 xorshift-multiply hash, the 24-bit
    uniform and E = -ln(u) / multiplicity; the winner per slot is the
    smallest E, ties to the smallest item (u32) or the first position
    (u64).  The f32 log is taken by the same jitted function the tournament
    uses, so the comparison is exact."""
    M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        x = (np.arange(m, dtype=np.uint64)
             + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = (x ^ (x >> np.uint64(31))) & M64
        slotc = (x >> np.uint64(32)).astype(np.uint32)
        wide = items.dtype == np.uint64
        it32 = ((items ^ (items >> np.uint64(32))).astype(np.uint32)
                if wide else items.astype(np.uint32))
        h = it32[..., None] ^ slotc
        h = h * np.uint32(0x9E3779B1)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x85EBCA77)
    nl = np.asarray(probminhash._neg_log_u24(h))
    e = np.abs(nl * winv[..., None].astype(np.float32))
    e = np.where(valid[..., None], e, np.inf)
    n, P = items.shape
    sig = np.zeros((n, m), items.dtype)
    for r in range(n):
        for s_ in range(m):
            col = e[r, :, s_]
            if not np.isfinite(col).any():
                continue
            winners = np.flatnonzero(col == col.min())
            if wide:
                sig[r, s_] = items[r, winners[0]]
            else:
                sig[r, s_] = items[r, winners].min()
    return sig, ~valid.any(axis=1)


class TestProbMinHash:
    def test_half_and_revcomp(self, pair):
        j_half, j_rc, theo = algo_jaccard(SketchAlgo.PROB3A, pair)
        assert abs(j_half - theo) < 0.12, (j_half, theo)
        assert j_rc == 1.0  # canonical kmers identical

    def test_weights_affect_sampling(self, rng):
        # two "reads" as weighted sets over the same 2 items: skewed weights
        # must skew slot ownership
        items = np.array([[1, 2]], dtype=np.uint64)
        w = np.array([[9, 1]], dtype=np.int32)
        sig, empty, ovf = probminhash.probminhash_signatures(items, w, 512)
        frac1 = float((np.asarray(sig) == 1).mean())
        assert abs(frac1 - 0.9) < 0.06
        assert not bool(np.asarray(empty)[0])

    def test_probjaccard_weighted(self):
        # J_P of {x:2, y:1} vs {x:1, y:1}: sum min / ... Probability Jaccard
        # J_P = sum_i 1 / sum_j max(w_Aj/w_Ai, w_Bj/w_Bi)
        # A = {x:2,y:1}, B = {x:1,y:1}:
        #  i=x: 1 / (max(1,1) + max(1/2, 1)) = 1/2
        #  i=y: 1 / (max(2,1) + max(1,1)) = 1/3
        # J_P = 5/6 * ... -> 1/2 + 1/3 = 0.8333
        a = probminhash.probminhash_signatures(
            np.array([[7, 9]], dtype=np.uint64), np.array([[2, 1]], np.int32), 2048)[0]
        b = probminhash.probminhash_signatures(
            np.array([[7, 9]], dtype=np.uint64), np.array([[1, 1]], np.int32), 2048)[0]
        est = float(probminhash.probjaccard_pair(a[0], b[0]))
        assert abs(est - 5 / 6) < 0.04

    def test_empty_read(self):
        sig, empty, _ = probminhash.probminhash_signatures(
            np.zeros((1, 4), np.uint64), np.zeros((1, 4), np.int32), 16)
        assert bool(np.asarray(empty)[0])

    def test_pallas_kernel_matches_xla_path(self, rng):
        # the fused-XLA tournament against a numpy transcription of the
        # same draw, u32 items: ties resolve to the smallest item
        n, P, m = 4, 700, 200
        items = rng.integers(0, 50, size=(n, P)).astype(np.uint32)
        w = rng.integers(1, 5, size=(n, P)).astype(np.int32)
        valid = rng.random((n, P)) < 0.9
        valid[3, :] = False
        winv = np.where(valid, 1.0 / w, 0.0).astype(np.float32)
        sig, empty = probminhash._tournament(items, winv, valid, m, 0)
        exp, exp_empty = _tournament_oracle(items, winv, valid, m, 0)
        assert (np.asarray(empty) == exp_empty).all()
        assert (np.asarray(sig) == exp).all()

    def test_pallas_wide_matches_xla_path(self, rng):
        # u64 items: the draw runs on the 32-bit fold and ties resolve to
        # the first position; the winner's full item is gathered back
        n, P, m = 4, 700, 200
        items = rng.integers(1, 1 << 62, size=(n, P), dtype=np.uint64)
        # duplicates to exercise equal-draw ties resolved by position
        items[:, 0::3][:, :233] = items[:, 1::3][:, :233]
        w = rng.integers(1, 5, size=(n, P)).astype(np.int32)
        valid = rng.random((n, P)) < 0.9
        valid[3, :] = False
        winv = np.where(valid, 1.0 / w, 0.0).astype(np.float32)
        sig, empty = probminhash._tournament(items, winv, valid, m, 0)
        exp, exp_empty = _tournament_oracle(items, winv, valid, m, 0)
        assert np.asarray(sig).dtype == np.uint64
        assert (np.asarray(empty) == exp_empty).all()
        assert (np.asarray(sig) == exp).all()

    def test_from_items_matches_explicit_weights(self, rng):
        # probminhash_from_items derives multiplicities internally (sort +
        # run-length scans); must agree with explicit-weight signatures —
        # including when rows end in padding (regression: sentinel padding
        # must not inflate the last run's multiplicity)
        import jax.numpy as jnp
        P = 37
        items = rng.integers(0, 8, size=(4, P)).astype(np.uint64)  # many dups
        lengths = np.array([P, P - 13, 5, 1])
        valid = np.arange(P)[None, :] < lengths[:, None]
        s1 = probminhash.probminhash_from_items(items, valid, 128)[0]
        w = np.zeros((4, P), np.int32)
        for r in range(4):
            vals, counts = np.unique(items[r, : lengths[r]], return_counts=True)
            lut = dict(zip(vals.tolist(), counts.tolist()))
            for p in range(lengths[r]):
                w[r, p] = lut[int(items[r, p])]
        s2 = probminhash.probminhash_signatures(items, w, 128)[0]
        assert (np.asarray(s1) == np.asarray(s2)).all()

    def test_heavy_cap_consistency(self, rng):
        # same multiset sketched with different caps (no overflow) is identical
        items = rng.integers(1, 1 << 60, size=(2, 64), dtype=np.uint64)
        w = rng.integers(1, 4, size=(2, 64)).astype(np.int32)
        s1 = probminhash.probminhash_signatures(items, w, 64, heavy_cap=64)[0]
        s2 = probminhash.probminhash_signatures(items, w, 64, heavy_cap=0)[0]
        assert (np.asarray(s1) == np.asarray(s2)).all()


class TestSuperMinHash:
    def test_half(self, pair):
        j_half, j_rc, theo = algo_jaccard(SketchAlgo.SUPER, pair)
        assert abs(j_half - theo) < 0.12, (j_half, theo)
        assert j_rc == 1.0

    def test_super2_matches_super(self, pair):
        j1, _, theo = algo_jaccard(SketchAlgo.SUPER, pair)
        j2, _, _ = algo_jaccard(SketchAlgo.SUPER2, pair)
        assert j1 == j2  # float sig is a monotone transform of the int sig

    def test_perm_is_permutation(self):
        from kmerutils_tpu.sketch.superminhash import _small_perm
        import jax.numpy as jnp
        for m in (7, 64, 200):
            j = np.arange(m, dtype=np.uint64)[None, :]
            key = np.full((1, 1), 0xDEADBEEF, dtype=np.uint64)
            p = np.asarray(_small_perm(jnp.asarray(j), jnp.asarray(key), m))[0]
            # cycle-walk clamping can very rarely break bijectivity; for these
            # fixed keys it must hold exactly
            assert sorted(p.tolist()) == list(range(m)), m


class TestDensMinHash:
    @pytest.mark.parametrize("algo", [SketchAlgo.OPTDENS, SketchAlgo.REVOPTDENS])
    def test_half(self, pair, algo):
        j_half, j_rc, theo = algo_jaccard(algo, pair)
        assert abs(j_half - theo) < 0.12, (algo, j_half, theo)
        assert j_rc == 1.0

    @pytest.mark.parametrize("fn", [densminhash.optdens_signatures,
                                    densminhash.revoptdens_signatures])
    def test_small_set_densifies(self, rng, fn):
        # fewer items than sketch slots: all slots must fill (the RevOptDens
        # regime, setsketchert.rs:490-495)
        items = rng.integers(1, 1 << 60, size=(3, 8), dtype=np.uint64)
        valid = np.ones((3, 8), bool)
        sig, empty = fn(items, valid, 64)
        assert np.isfinite(np.asarray(sig)).all()
        assert not np.asarray(empty).any()
        # identical item sets -> identical signatures
        sig2, _ = fn(items, valid, 64)
        assert (np.asarray(sig) == np.asarray(sig2)).all()


class TestSetSketch:
    def test_cardinality(self, rng):
        sp = SetSketchParams(m=1024)
        n_items = 5000
        items = rng.integers(1, 1 << 62, size=(1, n_items), dtype=np.uint64)
        regs = setsketch.setsketch_signatures(items, np.ones((1, n_items), bool), sp)
        est = float(setsketch.cardinality(regs, sp)[0])
        assert abs(est - n_items) / n_items < 0.15, est

    def test_merge_and_jaccard(self, rng):
        sp = SetSketchParams(m=1024)
        common = rng.integers(1, 1 << 61, size=1000, dtype=np.uint64)
        only_a = rng.integers(1, 1 << 61, size=1000, dtype=np.uint64)
        only_b = rng.integers(1, 1 << 61, size=1000, dtype=np.uint64)
        a = np.concatenate([common, only_a])[None, :]
        b = np.concatenate([common, only_b])[None, :]
        ra = setsketch.setsketch_signatures(a, np.ones_like(a, bool), sp)
        rb = setsketch.setsketch_signatures(b, np.ones_like(b, bool), sp)
        # merge must equal the sketch of the union
        u = np.concatenate([common, only_a, only_b])[None, :]
        ru = setsketch.setsketch_signatures(u, np.ones_like(u, bool), sp)
        assert (np.asarray(setsketch.merge(ra, rb)) == np.asarray(ru)).all()
        j = float(setsketch.jaccard(ra, rb, sp)[0])
        assert abs(j - 1 / 3) < 0.12, j

    def test_hll_sketcher_collection(self, pair):
        full, half, _ = pair
        params = SeqSketcherParams(kmer_size=K, sketch_size=512, algo=SketchAlgo.HLL,
                                   data_t=DataType.DNA)
        sk = Sketcher(params=params)
        regs = sk.sketch_collection(pack_ascii_reads([full, half]))
        assert regs.shape == (512,)


class TestBottomK:
    def test_bottomk_counts(self, rng):
        vals = np.array([[5, 3, 5, 9, 3, 3, 7, 11]], dtype=np.uint64)
        valid = np.ones((1, 8), bool)
        sk, counts = minhash.bottomk_sketch(vals, valid, 4)
        assert np.asarray(sk)[0].tolist() == [3, 5, 7, 9]
        assert np.asarray(counts)[0].tolist() == [3, 2, 1, 1]

    def test_invhash_roundtrip(self, rng):
        items = rng.integers(0, 1 << 28, size=(1, 50), dtype=np.uint64)
        valid = np.ones((1, 50), bool)
        sk, _ = minhash.sketch_items_invhash(items, valid, 10)
        back = np.asarray(minhash.invert_sketch(sk))
        assert set(back.ravel().tolist()) <= set(items.ravel().tolist())

    def test_minhash_distance(self, rng):
        common = rng.integers(1, 1 << 40, size=500, dtype=np.uint64)
        oa = rng.integers(1 << 41, 1 << 42, size=500, dtype=np.uint64)
        ob = rng.integers(1 << 43, 1 << 44, size=500, dtype=np.uint64)
        a = np.concatenate([common, oa])[None, :]
        b = np.concatenate([common, ob])[None, :]
        ska, _ = minhash.sketch_items(a, np.ones_like(a, bool), 200)
        skb, _ = minhash.sketch_items(b, np.ones_like(b, bool), 200)
        cont, jac, cm, tot = minhash.minhash_distance(ska[0], skb[0])
        assert abs(jac - 1 / 3) < 0.12, jac


class TestDriver:
    def test_jaccard_one_vs_many(self, pair):
        full, half, theo = pair
        params = SeqSketcherParams(kmer_size=K, sketch_size=M,
                                   algo=SketchAlgo.PROB3A, data_t=DataType.DNA)
        ja = np.asarray(jaccard_one_vs_many(
            pack_ascii_reads([full]),
            pack_ascii_reads([half, full, revcomp_str(full)]), params))
        assert abs(float(ja[0]) - theo) < 0.12
        assert float(ja[1]) == 1.0
        assert float(ja[2]) == 1.0

    def test_params_json_roundtrip(self, tmp_path):
        p = SeqSketcherParams(8, 200, SketchAlgo.PROB3A, DataType.DNA)
        f = tmp_path / "sketchparams_dump.json"
        p.dump_json(str(f))
        back = SeqSketcherParams.reload_json(str(tmp_path))
        assert back == p


class TestGoldenParity:
    """PARITY.md §3: measured statistical agreement between the device
    ProbMinHash sampler and the golden host implementation of Ertl's
    published sequential ProbMinHash3 (sketch/golden.py)."""

    def test_estimator_agreement_vs_exact_jp(self):
        from kmerutils_tpu.sketch import golden

        rng = np.random.default_rng(5)
        items = rng.integers(1, 2**31, 60, dtype=np.uint64)
        wa = {int(d): int(w) for d, w in
              zip(items, rng.integers(1, 6, 60))}
        wb = {int(d): int(w) for d, w in
              zip(items[:40], rng.integers(1, 6, 40))}   # 40/60 shared
        jp = golden.probjaccard_exact(
            {k: float(v) for k, v in wa.items()},
            {k: float(v) for k, v in wb.items()})
        m, trials = 64, 40

        ka = np.array(sorted(wa), dtype=np.uint64)
        va = np.array([wa[int(k)] for k in ka], dtype=np.int32)
        kb = np.array(sorted(wb), dtype=np.uint64)
        vb = np.array([wb[int(k)] for k in kb], dtype=np.int32)
        est_t, est_g = [], []
        for s in range(trials):
            sa = probminhash.probminhash_signatures(
                ka[None], va[None], m, seed=s)[0]
            sb = probminhash.probminhash_signatures(
                kb[None], vb[None], m, seed=s)[0]
            est_t.append(float((np.asarray(sa[0]) == np.asarray(sb[0]))
                               .mean()))
            ga = golden.probminhash3_golden(ka, va, m, seed=s)
            gb = golden.probminhash3_golden(kb, vb, m, seed=s)
            est_g.append(float((ga == gb).mean()))
        mt, mg = np.mean(est_t), np.mean(est_g)
        st, sg = np.std(est_t), np.std(est_g)
        # both samplers must be unbiased estimators of the same J_P with
        # the binomial-order variance sqrt(J(1-J)/m)
        tol = 3.5 * np.sqrt(jp * (1 - jp) / m / trials) + 0.01
        assert abs(mt - jp) < tol, (mt, jp, tol)
        assert abs(mg - jp) < tol, (mg, jp, tol)
        ref_sd = np.sqrt(jp * (1 - jp) / m)
        assert 0.5 * ref_sd < st < 1.6 * ref_sd, (st, ref_sd)
        assert 0.5 * ref_sd < sg < 1.6 * ref_sd, (sg, ref_sd)


class TestGoldenParityAllFamilies:
    """PARITY.md §3 round-3 extension: the remaining sketcher families
    measured against golden host implementations of their published
    algorithms (sketch/golden.py) — SuperMinHash (Ertl 2017), OptDens
    (Shrivastava 2017), RevOptDens (Mai 2020), SetSketch (Ertl 2021).
    Both samplers must estimate the same exact Jaccard unbiasedly with
    binomial-order variance; tools/golden_parity.py produces the full
    table."""

    def _overlap_sets(self):
        rng = np.random.default_rng(17)
        pool = rng.integers(1, 2**62, 120, dtype=np.uint64)
        a, b = pool[:60], pool[20:80]      # exact J = 40/80
        return a, b, 0.5

    def _assert_both(self, est_t, est_g, jex, m, trials):
        mt, mg = np.mean(est_t), np.mean(est_g)
        tol = 3.5 * np.sqrt(jex * (1 - jex) / m / trials) + 0.02
        assert abs(mt - jex) < tol, (mt, jex, tol)
        assert abs(mg - jex) < tol, (mg, jex, tol)
        ref_sd = np.sqrt(jex * (1 - jex) / m)
        # SuperMinHash's variance is strictly BELOW binomial for small
        # sets (Ertl 2017), so only the upper bound is family-generic
        assert np.std(est_t) < 1.7 * ref_sd, (np.std(est_t), ref_sd)
        assert np.std(est_g) < 1.7 * ref_sd, (np.std(est_g), ref_sd)

    def test_superminhash_vs_golden(self):
        from kmerutils_tpu.sketch import golden, superminhash
        a, b, jex = self._overlap_sets()
        m, trials = 64, 24
        va = np.ones((1, a.size), bool)
        vb = np.ones((1, b.size), bool)
        est_t, est_g = [], []
        for s in range(trials):
            sa, _ = superminhash.superminhash2(a[None], va, m, s)
            sb, _ = superminhash.superminhash2(b[None], vb, m, s)
            est_t.append(float((np.asarray(sa)[0] == np.asarray(sb)[0])
                               .mean()))
            _, wa = golden.superminhash_golden(a, m, s)
            _, wb = golden.superminhash_golden(b, m, s)
            est_g.append(float((wa == wb).mean()))
        self._assert_both(est_t, est_g, jex, m, trials)

    def test_optdens_vs_golden(self):
        from kmerutils_tpu.sketch import golden, densminhash
        a, b, jex = self._overlap_sets()
        m, trials = 64, 24
        va = np.ones((1, a.size), bool)
        vb = np.ones((1, b.size), bool)
        est_t, est_g = [], []
        for s in range(trials):
            sa, _ = densminhash.optdens_signatures(a[None], va, m, s)
            sb, _ = densminhash.optdens_signatures(b[None], vb, m, s)
            est_t.append(float((np.asarray(sa)[0] == np.asarray(sb)[0])
                               .mean()))
            ga, _ = golden.optdens_golden(a, m, s)
            gb, _ = golden.optdens_golden(b, m, s)
            est_g.append(float((ga == gb).mean()))
        self._assert_both(est_t, est_g, jex, m, trials)

    def test_revoptdens_vs_golden(self):
        from kmerutils_tpu.sketch import golden, densminhash
        a, b, jex = self._overlap_sets()
        m, trials = 64, 24
        va = np.ones((1, a.size), bool)
        vb = np.ones((1, b.size), bool)
        est_t, est_g = [], []
        for s in range(trials):
            sa, _ = densminhash.revoptdens_signatures(a[None], va, m, s)
            sb, _ = densminhash.revoptdens_signatures(b[None], vb, m, s)
            est_t.append(float((np.asarray(sa)[0] == np.asarray(sb)[0])
                               .mean()))
            ga, _ = golden.revoptdens_golden(a, m, s)
            gb, _ = golden.revoptdens_golden(b, m, s)
            est_g.append(float((ga == gb).mean()))
        self._assert_both(est_t, est_g, jex, m, trials)

    def test_setsketch_vs_golden(self):
        from kmerutils_tpu.sketch import golden
        from kmerutils_tpu.sketch import setsketch as ss
        rng = np.random.default_rng(23)
        n, m, trials = 400, 64, 8
        items = rng.integers(1, 2**62, n, dtype=np.uint64)
        p = ss.SetSketchParams(m=m)
        est_t, est_g = [], []
        for s in range(trials):
            regs_t = np.asarray(ss.setsketch_signatures(
                items[None], np.ones((1, n), bool), p, s))[0]
            est_t.append(float(np.asarray(
                ss.cardinality(regs_t[None], p))[0]))
            regs_g = golden.setsketch_golden(items, m, p.b, p.a, p.q, s)
            est_g.append(golden.setsketch_cardinality_golden(
                regs_g, m, p.b, p.a))
        sd_theory = n / np.sqrt(m)         # HLL-order relative error
        for label, est in (("device", est_t), ("golden", est_g)):
            assert abs(np.mean(est) - n) < 3.5 * sd_theory / np.sqrt(
                trials) + 0.05 * n, (label, np.mean(est))
            assert np.std(est) < 2.5 * sd_theory, (label, np.std(est))
        # register law: both samplers' mean register within each other's
        # sampling noise (the truncated-geometric law has sd ~ 1/ln b per
        # register -> mean-register sd ~ 1/(ln b * sqrt(m)))
        regs_t = np.asarray(ss.setsketch_signatures(
            items[None], np.ones((1, n), bool), p, 0))[0]
        regs_g = golden.setsketch_golden(items, m, p.b, p.a, p.q, 0)
        sd_mean_reg = (1.0 / np.log(p.b)) / np.sqrt(m)
        assert abs(regs_t.astype(np.float64).mean()
                   - regs_g.astype(np.float64).mean()) < 4 * sd_mean_reg
