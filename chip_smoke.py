"""On-device smoke check of the engine's main paths.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card, phases 1-5
    python chip_smoke.py --four-cards  # the sharded counter on 4 cards only

Phases (any failure exits non-zero and prints no result line):

1. device: JAX must report platform ``gpu`` (no CPU fallback); prints the
   device kind and count, the card's name and power limit, and whether the
   native C++ FASTQ parser was built and loaded.
2. ops: the streaming table's fold and aggregate (ops/merge.py) against a
   numpy reference at a 2^26-entry table and a 1024x8192 batch, narrow and
   wide keys, with and without coordinates; integer-only, so exact.
3. count: ``parsefastq kmer --count`` at k = 16 and k = 31 on a FASTQ made
   from ``--seed`` (a 4.6 Mbase random genome, the size of E. coli K-12
   MG1655, at 30x coverage; ONT-like lognormal read lengths, median 5 kb,
   sigma 0.85, clipped to [500, 16000]; 1% uniform substitutions), reloaded
   with io/formats and compared exactly with a numpy oracle (canonical
   k-mers from the 2-bit codes, ``np.unique``, min_count 2, u8 clamp); then
   ``kmer -s 16 --unique`` (coordinates) on a 10 Mbase slice, likewise.
4. sketch: ``datasketcher -s 200 -k 8`` on the same file; 256 sampled reads
   are sketched again by the same jitted step on the CPU backend, and at
   least 99.9% of slots must agree (the draw takes an f32 ``log``, whose
   last bit may differ between backends; the path has no matrix products,
   so TF32 plays no part).  Prints the step's compiled memory analysis.
5. timing: wall time and Mbases/s of phases 3-4, informational.

``--four-cards`` runs one phase instead: parallel/stream.ShardedStreamCounter
on a 4-card mesh at k = 16 and k = 31 with coordinates on the phase-3 file;
its ``finalize`` must equal the single-card table's exactly, with no
in-transit drops.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

GENOME_LEN = 4_641_652          # E. coli K-12 MG1655 (NCBI NC_000913.3)
COVERAGE = 30
SUBST_RATE = 0.01
UNIQUE_SLICE_BASES = 10_000_000
_ACGT = np.frombuffer(b"ACGT", np.uint8)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_name() -> str:
    """``name, power.limit`` as nvidia-smi reports them, or a reason."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi printed nothing"


# ---------------------------------------------------------------------------
# phase 2: ops vs numpy
# ---------------------------------------------------------------------------

def _packed(words, ncmp):
    if ncmp == 1:
        return words[0].astype(np.uint64)
    return (words[0].astype(np.uint64) << np.uint64(32)) | words[1]


def _random_entries(rng, n, wide, coords, key_range, counts):
    keys = np.sort(rng.integers(1, key_range, n, dtype=np.uint64))
    arrs = ([(keys >> np.uint64(32)).astype(np.uint32),
             keys.astype(np.uint32)] if wide else [keys.astype(np.uint32)])
    arrs.append(counts)
    if coords:
        arrs += [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                 for _ in range(2)]
    return arrs


def _agg_oracle(arrs, kw, coords, lo, hi):
    """Run aggregation by numpy: heads where the packed key changes,
    counts by np.add.reduceat (saturated at 2^32-1), coordinates by
    np.minimum.reduceat, then the [lo, hi] count filter."""
    if arrs[0].size == 0:
        return [a[:0] for a in arrs]
    key = _packed(arrs[:kw], kw)
    heads = np.flatnonzero(np.concatenate([[True], key[1:] != key[:-1]]))
    tot = np.minimum(np.add.reduceat(arrs[kw].astype(np.uint64), heads),
                     np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = [a[heads] for a in arrs[:kw]] + [tot]
    if coords:
        c = _packed(arrs[kw + 1:kw + 3], 2)
        cm = np.minimum.reduceat(c, heads)
        out += [(cm >> np.uint64(32)).astype(np.uint32),
                cm.astype(np.uint32)]
    keep = (tot >= lo) & (tot <= (0xFFFFFFFF if hi is None else hi))
    return [a[keep] for a in out]


def check_fold_aggregate(rng, cap, nb, wide, coords):
    """One fold + one aggregate at (capacity, batch) against numpy."""
    import jax
    import jax.numpy as jnp
    from kmerutils_tpu.ops import merge

    ncmp = kw = 2 if wide else 1
    used = cap // 4
    live_b = nb - nb // 64                       # dead all-ones tail
    key_range = (used // 2) << (32 if wide else 0)   # duplicate-rich keys
    cnt = rng.integers(1, 1000, used, dtype=np.uint64).astype(np.uint32)
    cnt[rng.random(used) < 1e-3] = 0xFFFFFFF0    # saturating runs
    A = _random_entries(rng, used, wide, coords, key_range, cnt)
    B = _random_entries(rng, live_b, wide, coords, key_range,
                        np.ones(live_b, np.uint32))
    B = [np.concatenate([b, np.full(nb - live_b, 0xFFFFFFFF, np.uint32)])
         for b in B]
    table = []
    for j, a in enumerate(A):
        full = np.full(cap, 0xFFFFFFFF, np.uint32)
        full[:used] = a
        if j < ncmp:
            full ^= np.uint32(0x80000000)
        table.append(jnp.asarray(full.view(np.int32)))
    merged = merge.merge_fold_i32(tuple(table), tuple(jnp.asarray(b)
                                                      for b in B),
                                  used, ncmp=ncmp)
    m = min(used + live_b, cap)
    lo, hi = (1, 1) if coords else (2, None)
    agg, n_live = merge.aggregate_fold_i32(merged, m, kw=kw, coords=coords,
                                           lo=lo, hi=hi)
    merged = [np.asarray(x)[:m].view(np.uint32) for x in merged]
    n_live = int(n_live)
    agg = [np.asarray(x)[:n_live].view(np.uint32) for x in agg]
    for j in range(ncmp):
        merged[j] = merged[j] ^ np.uint32(0x80000000)
        agg[j] = agg[j] ^ np.uint32(0x80000000)

    cat = [np.concatenate([a, b[:live_b]]) for a, b in zip(A, B)]
    order = np.argsort(_packed(cat[:ncmp], ncmp), kind="stable")[:m]
    exp = [c[order] for c in cat]
    for j, (g, e) in enumerate(zip(merged, exp)):
        check(np.array_equal(g, e), f"fold word {j} differs from numpy "
              f"(wide={wide}, coords={coords})")
    exp_agg = _agg_oracle(exp, kw, coords, lo, hi)
    check(n_live == exp_agg[0].size,
          f"aggregate count {n_live} != numpy {exp_agg[0].size}")
    for j, (g, e) in enumerate(zip(agg, exp_agg)):
        check(np.array_equal(g, e), f"aggregate word {j} differs from numpy "
              f"(wide={wide}, coords={coords})")
    jax.block_until_ready(merged)
    return m, n_live


def phase_ops(seed: int, cap_log2: int = 26, batch: int = 1024 * 8192):
    rng = np.random.default_rng(seed)
    out = {}
    for wide in (False, True):
        for coords in (False, True):
            out[(wide, coords)] = check_fold_aggregate(
                rng, 1 << cap_log2, batch, wide, coords)
    return out


# ---------------------------------------------------------------------------
# phase 3: counting through the CLI vs a numpy oracle
# ---------------------------------------------------------------------------

def make_reads(seed: int, genome_len: int = GENOME_LEN,
               coverage: int = COVERAGE, subst: float = SUBST_RATE):
    """Reads sampled from a random genome: (flat 2-bit codes, lengths)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    hi = min(16000, genome_len)
    lens = []
    total = 0
    while total < genome_len * coverage:
        blk = np.clip(rng.lognormal(np.log(5000), 0.85, 4096), 500,
                      hi).astype(np.int64)
        lens.append(blk)
        total += int(blk.sum())
    lens = np.concatenate(lens)
    lens = lens[: np.searchsorted(np.cumsum(lens), genome_len * coverage) + 1]
    starts = rng.integers(0, genome_len - lens + 1)
    offs = np.concatenate([[0], np.cumsum(lens)])
    idx = np.repeat(starts - offs[:-1], lens) + np.arange(offs[-1])
    flat = genome[idx]
    # half the reads come from the reverse strand
    rev = rng.random(lens.size) < 0.5
    for i in np.flatnonzero(rev):
        s = slice(offs[i], offs[i + 1])
        flat[s] = 3 - flat[s][::-1]
    err = rng.random(flat.size) < subst
    flat[err] = (flat[err] + rng.integers(1, 4, int(err.sum()),
                                          dtype=np.uint8)) % 4
    return flat, lens


def write_fastq(path: str, flat, lens) -> None:
    offs = np.concatenate([[0], np.cumsum(lens)])
    ascii_ = _ACGT[flat]
    with open(path, "wb") as f:
        parts = []
        for i in range(lens.size):
            seq = ascii_[offs[i]:offs[i + 1]].tobytes()
            parts += [b"@r%d\n" % i, seq, b"\n+\n", b"I" * len(seq), b"\n"]
            if len(parts) >= 5000:
                f.write(b"".join(parts))
                parts = []
        f.write(b"".join(parts))


def canonical_oracle(flat, lens, k: int):
    """(canonical k-mer value, read index, position) of every k-mer, by
    numpy: big-endian 2-bit values, revcomp by complement + reversal."""
    n = flat.size - k + 1
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for i in range(k):
        seg = flat[i:i + n].astype(np.uint64)
        fwd = (fwd << np.uint64(2)) | seg
        rc |= (np.uint64(3) - seg) << np.uint64(2 * i)
    can = np.minimum(fwd, rc)
    offs = np.concatenate([[0], np.cumsum(lens)])
    read = np.repeat(np.arange(lens.size), lens)[:n]
    pos = np.arange(n) - offs[read]
    ok = pos + k <= lens[read]
    return can[ok], read[ok], pos[ok]


def _run_cli(mod, argv, workdir) -> float:
    """Run a CLI's main() in workdir (its histogram files land there);
    returns its wall seconds."""
    cwd = os.getcwd()
    os.chdir(workdir)
    t0 = time.perf_counter()
    try:
        rc = mod.main(argv)
    finally:
        os.chdir(cwd)
    check(rc == 0, f"{mod.__name__} {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def check_count(fq, flat, lens, k, workdir):
    from kmerutils_tpu.cli import parsefastq
    from kmerutils_tpu.io import formats
    dt = _run_cli(parsefastq, ["-f", fq, "kmer", "--count", "-s", str(k)],
                  workdir)
    kk, d = formats.read_multiple_kmer_dump(fq + ".multi_kmer.bin")
    check(kk == k, f"dump k {kk} != {k}")
    got_k = np.fromiter(d.keys(), np.uint64, len(d))
    got_c = np.fromiter(d.values(), np.int64, len(d))
    can, _, _ = canonical_oracle(flat, lens, k)
    keys, counts = np.unique(can, return_counts=True)
    keep = counts >= 2
    exp_k, exp_c = keys[keep], np.minimum(counts[keep], 255)
    check(np.array_equal(got_k, exp_k) and np.array_equal(got_c, exp_c),
          f"k={k} counts differ from numpy ({got_k.size} vs {exp_k.size} "
          f"records)")
    return int(can.size), int(keys.size), int(exp_k.size), dt


def check_unique(fq, flat, lens, workdir):
    from kmerutils_tpu.cli import parsefastq
    from kmerutils_tpu.io import formats
    dt = _run_cli(parsefastq, ["-f", fq, "kmer", "--unique", "-s", "16"],
                  workdir)
    _, keys, rn, ps = formats.read_unique_kmer_dump(fq + ".once_kmer.bin")
    can, read, pos = canonical_oracle(flat, lens, 16)
    u, first, counts = np.unique(can, return_index=True, return_counts=True)
    once = first[counts == 1]
    order = np.lexsort((pos[once], read[once]))
    once = once[order]
    check(np.array_equal(keys.astype(np.uint64), can[once])
          and np.array_equal(rn, read[once]) and np.array_equal(ps, pos[once]),
          f"unique k-mers differ from numpy ({keys.size} vs {once.size})")
    return int(once.size), dt


def slice_reads(flat, lens, max_bases):
    n = int(np.searchsorted(np.cumsum(lens), max_bases, side="right"))
    n = max(n, 1)
    return flat[: int(lens[:n].sum())], lens[:n]


# ---------------------------------------------------------------------------
# phase 4: sketching through the CLI vs the CPU backend
# ---------------------------------------------------------------------------

def _sketcher():
    from kmerutils_tpu.sketch.jaccard import Sketcher
    from kmerutils_tpu.sketch.params import (SeqSketcherParams, SketchAlgo,
                                             DataType)
    return Sketcher(params=SeqSketcherParams(
        kmer_size=8, sketch_size=200, algo=SketchAlgo.PROB3A,
        data_t=DataType.DNA))


def sketch_memory(rows: int = 1024, width: int = 8192) -> str:
    """Compiled memory analysis of the sketch step at one batch shape."""
    import jax
    fn = jax.jit(_sketcher()._batch_fn())
    w = jax.ShapeDtypeStruct((rows, width // 16 + 1), np.uint32)
    n = jax.ShapeDtypeStruct((rows,), np.int32)
    ma = fn.lower(w, n).compile().memory_analysis()
    if ma is None:
        return "memory analysis unavailable"
    return (f"temp {ma.temp_size_in_bytes} B, arguments "
            f"{ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B")


def check_sketch(fq, flat, lens, workdir, n_sample: int, seed: int):
    import jax
    from kmerutils_tpu.base.sequence import pack_codes
    from kmerutils_tpu.cli import datasketcher
    from kmerutils_tpu.io import formats
    dump = os.path.join(workdir, "sketch.sig")
    dt = _run_cli(datasketcher, ["-f", fq, "-s", "200", "-k", "8", "-d",
                                 dump], workdir)
    _, m, sigs = formats.read_signature_dump(dump)
    check(sigs.shape == (lens.size, 200), f"signature dump {sigs.shape}")
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(lens.size, min(n_sample, lens.size),
                              replace=False))
    offs = np.concatenate([[0], np.cumsum(lens)])
    L = int(lens[pick].max())
    codes = np.zeros((pick.size, L), np.uint8)
    for r, i in enumerate(pick):
        codes[r, :lens[i]] = flat[offs[i]:offs[i + 1]]
    batch = pack_codes(codes, lens[pick], as_numpy=True)
    cpu = jax.devices("cpu")[0]
    from kmerutils_tpu.base.sequence import ReadBatch
    ref = _sketcher().sketch_batch(ReadBatch(
        words=jax.device_put(batch.words, cpu),
        lengths=jax.device_put(batch.lengths, cpu)))
    share = float((np.asarray(ref) == sigs[pick]).mean())
    check(share >= 0.999, f"only {share:.5f} of signature slots agree "
          "with the CPU backend")
    return share, dt


# ---------------------------------------------------------------------------
# --four-cards: the sharded counter vs the single-card table
# ---------------------------------------------------------------------------

def count_single(fq, k):
    """Whole-file counts with coordinates through one card's table."""
    import jax
    from kmerutils_tpu.count import stream
    from kmerutils_tpu.io import fastx
    from kmerutils_tpu.cli.parsefastq import _auto_capacity
    prep = jax.jit(stream.batch_entries, static_argnames=("k", "coords"))
    folder = stream.StagedFolder(stream.StreamCountTable.create(
        _auto_capacity(fq, True), wide=k > 16, coords=True))
    offset = 0
    for batch, idx in fastx.read_batches(fq, bucket=False):
        folder.push(*prep(batch, k=k, read_num_offset=offset, coords=True))
        offset += len(idx)
    return stream.finalize(folder.flush())


def count_sharded(fq, k, mesh, cap_per_device):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.io import fastx
    from kmerutils_tpu.parallel import stream as pstream
    from kmerutils_tpu.parallel.mesh import READS_AXIS
    sh = NamedSharding(mesh, P(READS_AXIS))
    ctr = pstream.ShardedStreamCounter(mesh, cap_per_device, wide=k > 16,
                                       coords=True)
    offset = 0
    for batch, idx in fastx.read_batches(fq, bucket=False, to_host=True):
        ctr.update(ReadBatch(words=jax.device_put(batch.words, sh),
                             lengths=jax.device_put(batch.lengths, sh)),
                   k, read_num_offset=offset)
        offset += len(idx)
    res = ctr.finalize()
    return res, ctr.dropped_in_transit


def phase_four_cards(fq, n_dev: int = 4, cap_per_device: int = 1 << 26):
    from kmerutils_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(n_dev)
    out = {}
    for k in (16, 31):
        single = count_single(fq, k)
        sharded, in_transit = count_sharded(fq, k, mesh, cap_per_device)
        check(in_transit == 0, f"k={k}: {in_transit} in-transit drops")
        check(single[4] == 0 and sharded[4] == 0, f"k={k}: table drops")
        for name, a, b in zip(("keys", "counts", "read_nums", "positions"),
                              single[:4], sharded[:4]):
            check(np.array_equal(a, b),
                  f"k={k}: sharded {name} differ from the single card")
        out[k] = int(single[0].size)
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _timing(label, seconds, bases, card):
    print(f"time {label}: {seconds:.2f} s, {bases / seconds / 1e6:.2f} "
          f"Mbases/s [{card}] (informational)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded counter on 4 cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(HERE, ".smoke"))
    args = ap.parse_args(argv)

    # the CPU backend is the sketch phase's reference; keep it reachable
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    import kmerutils_tpu  # noqa: F401
    from kmerutils_tpu.io import native

    # phase 1: device
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX reports {dev.platform}); "
              "refusing to fall back", file=sys.stderr)
        return 1
    card = card_name()
    n_want = 4 if args.four_cards else 1
    if len(devs) < n_want:
        print(f"chip_smoke: {len(devs)} GPU(s), need {n_want}",
              file=sys.stderr)
        return 1
    print(f"device: {dev.platform} {dev.device_kind} x{len(devs)}",
          flush=True)
    print(f"card: {card}", flush=True)
    print(f"native parser: {'loaded' if native.available() else 'MISSING'}",
          flush=True)

    os.makedirs(args.workdir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        flat, lens = make_reads(args.seed)
        fq = os.path.join(args.workdir, "reads.fastq")
        write_fastq(fq, flat, lens)
        print(f"fixture: {lens.size} reads, {int(lens.sum())} bases "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if args.four_cards:
            t0 = time.perf_counter()
            out = phase_four_cards(fq)
            _timing("four_cards (both k, single + sharded)",
                    time.perf_counter() - t0, 4 * int(lens.sum()), card)
            print(f"four cards: sharded == single card, records {out}",
                  flush=True)
        else:
            t0 = time.perf_counter()
            res = phase_ops(args.seed)
            print(f"ops: fold + aggregate == numpy {res} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            for k in (16, 31):
                n_kmers, n_distinct, n_rec, dt = check_count(
                    fq, flat, lens, k, args.workdir)
                _timing(f"parsefastq kmer --count -s {k}", dt,
                        int(lens.sum()), card)
                print(f"count k={k}: {n_kmers} k-mers, {n_distinct} "
                      f"distinct, {n_rec} records == numpy", flush=True)
            sf, sl = slice_reads(flat, lens, UNIQUE_SLICE_BASES)
            fq_u = os.path.join(args.workdir, "slice.fastq")
            write_fastq(fq_u, sf, sl)
            n_once, dt = check_unique(fq_u, sf, sl, args.workdir)
            _timing("parsefastq kmer --unique -s 16", dt, int(sl.sum()),
                    card)
            print(f"unique k=16: {n_once} once-seen k-mers == numpy",
                  flush=True)
            print(f"sketch step memory (1024 x 8192): {sketch_memory()}",
                  flush=True)
            share, dt = check_sketch(fq, flat, lens, args.workdir, 256,
                                     args.seed)
            _timing("datasketcher -s 200 -k 8", dt, int(lens.sum()), card)
            print(f"sketch: {share:.6f} of slots equal the CPU backend",
                  flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
