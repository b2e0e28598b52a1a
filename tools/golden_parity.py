"""Measure PARITY.md §3 numbers: device samplers vs golden host implementations
of the published algorithms, for ALL sketcher families.

ProbMinHash3's table is produced by tests/test_sketch.py::TestGoldenParity's
construction; this script covers the remaining families :
SuperMinHash (Ertl 2017), OptDens (Shrivastava 2017), RevOptDens (Mai 2020),
SetSketch (Ertl 2021).  For each scenario it reports the estimator mean+-sd
over independent seeds for BOTH samplers against the exact Jaccard, plus the
binomial reference sd; for SetSketch it also reports cardinality-estimator
agreement and the register-law fit.

Run (small shapes; forces the CPU backend so it never contends with work
on the accelerator; KMERUTILS_PARITY_BACKEND=default keeps JAX's choice):
  PYTHONPATH=. python tools/golden_parity.py
"""

import os

import numpy as np

import jax

if os.environ.get("KMERUTILS_PARITY_BACKEND", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import kmerutils_tpu  # noqa: F401
from kmerutils_tpu.sketch import golden, superminhash, densminhash, setsketch

M = 256
TRIALS = 100


def scenarios(rng):
    """(name, items_a, items_b, exact_J) — unweighted overlap scenarios."""
    pool = rng.integers(1, 2**62, 200, dtype=np.uint64)
    out = []
    a = pool[:60]
    b = pool[:60]                         # identical -> J = 1 sanity? skip
    a = pool[:60]; b = pool[20:80]        # 40 shared / 80 union = 0.5
    out.append(("overlap 0.50", a, b, 40 / 80))
    a = pool[:60]; b = pool[40:120]       # 20 shared / 120 union
    out.append(("overlap 0.17", a, b, 20 / 120))
    a = pool[:60]; b = pool[52:130]       # 8 shared / 130 union
    out.append(("overlap 0.06", a, b, 8 / 130))
    return out


def run_family(name, dev_fn, golden_fn, rng):
    print(f"\n== {name} (m={M}, {TRIALS} seeds) ==")
    for sname, a, b, jex in scenarios(rng):
        est_t, est_g = [], []
        va = np.ones((1, a.size), bool)
        vb = np.ones((1, b.size), bool)
        for s in range(TRIALS):
            sa = np.asarray(dev_fn(a[None], va, M, s))
            sb = np.asarray(dev_fn(b[None], vb, M, s))
            est_t.append(float((sa[0] == sb[0]).mean()))
            if s < TRIALS // 2:           # golden is host-sequential
                ga = golden_fn(a, M, s)
                gb = golden_fn(b, M, s)
                est_g.append(float((ga == gb).mean()))
        bt = np.sqrt(jex * (1 - jex) / M)
        print(f"  {sname}: exact {jex:.4f} | device {np.mean(est_t):.4f}"
              f" +- {np.std(est_t):.4f} | golden {np.mean(est_g):.4f}"
              f" +- {np.std(est_g):.4f} | binom sd {bt:.4f}")


def dev_super(items, valid, m, seed):
    sig, _ = superminhash.superminhash2(items, valid, m, seed)
    return sig


def golden_super(items, m, seed):
    _, win = golden.superminhash_golden(items, m, seed)
    return win


def dev_optdens(items, valid, m, seed):
    sig, _ = densminhash.optdens_signatures(items, valid, m, seed)
    return sig


def golden_optdens(items, m, seed):
    s, _ = golden.optdens_golden(items, m, seed)
    return s


def dev_revoptdens(items, valid, m, seed):
    sig, _ = densminhash.revoptdens_signatures(items, valid, m, seed)
    return sig


def golden_revoptdens(items, m, seed):
    s, _ = golden.revoptdens_golden(items, m, seed)
    return s


def run_setsketch(rng):
    p = setsketch.SetSketchParams(m=M)
    print(f"\n== SetSketch (b={p.b}, a={p.a}, m={M}) ==")
    n = 1000
    items = rng.integers(1, 2**62, n, dtype=np.uint64)
    # cardinality estimator, both samplers, 20 seeds
    est_t, est_g = [], []
    for s in range(20):
        regs_t = np.asarray(setsketch.setsketch_signatures(
            items[None], np.ones((1, n), bool), p, s))[0]
        est_t.append(float(np.asarray(
            setsketch.cardinality(regs_t[None], p))[0]))
        if s < 10:
            regs_g = golden.setsketch_golden(items, M, p.b, p.a, p.q, s)
            est_g.append(golden.setsketch_cardinality_golden(
                regs_g, M, p.b, p.a))
    print(f"  cardinality(n={n}): device {np.mean(est_t):.1f} "
          f"+- {np.std(est_t):.1f} | golden {np.mean(est_g):.1f} "
          f"+- {np.std(est_g):.1f} | theory sd ~ n/sqrt(m) "
          f"{n/np.sqrt(M):.1f}")
    # register-law fit: empirical mean register vs closed form
    # E[b^-K] = 1/(n a ln b) (1 - 1/b) approx; compare sum b^-K
    regs_t = np.asarray(setsketch.setsketch_signatures(
        items[None], np.ones((1, n), bool), p, 0))[0]
    regs_g = golden.setsketch_golden(items, M, p.b, p.a, p.q, 0)
    print(f"  mean register: device {regs_t.mean():.1f} | golden "
          f"{regs_g.mean():.1f}")
    # Jaccard via inclusion-exclusion on a 50% overlap
    a = rng.integers(1, 2**62, 800, dtype=np.uint64)
    b = np.concatenate([a[:400], rng.integers(1, 2**62, 400,
                                              dtype=np.uint64)])
    jt = []
    for s in range(20):
        ra = np.asarray(setsketch.setsketch_signatures(
            a[None], np.ones((1, 800), bool), p, s))[0]
        rb = np.asarray(setsketch.setsketch_signatures(
            b[None], np.ones((1, 800), bool), p, s))[0]
        jt.append(float(np.asarray(setsketch.jaccard(
            ra[None], rb[None], p))[0]))
    print(f"  jaccard(0.333 exact): device {np.mean(jt):.4f} "
          f"+- {np.std(jt):.4f}")


def main():
    rng = np.random.default_rng(1234)
    run_family("SuperMinHash", dev_super, golden_super, rng)
    run_family("OptDens", dev_optdens, golden_optdens, rng)
    run_family("RevOptDens", dev_revoptdens, golden_revoptdens, rng)
    run_setsketch(rng)


if __name__ == "__main__":
    main()
