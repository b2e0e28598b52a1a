"""North-star benchmark: per-read ProbMinHash signatures (k=8, 200 sketches
per read) over an ONT-like read set — the workload the reference times at
51 s / 4.38 Gbases on an 8-core laptop (README.md:45, BASELINE.md).

Runs on a GPU only: it refuses any other platform, and prints the device
kind and the card's name and power limit first.

Output protocol: after every completed section this script prints ONE
complete, flushed JSON line
  {"metric": ..., "value": N, "unit": "Mbases/s", "vs_baseline": N/85.9,
   "extra": {...}}
carrying every number measured SO FAR.  Sections are gated by a wall
budget (KMERUTILS_BENCH_BUDGET_S, default 1140 s): a section whose minimum
remaining-cost estimate exceeds the remaining budget is recorded as
{"skipped": "budget"}.  The exit code is non-zero if any section raised.

The headline metric is the full on-device pipeline: packed words ->
canonical 8-mers -> wang hash -> per-read multiplicities -> ProbMinHash
signatures (200 slots), steady state.  `extra` carries the end-to-end
on-disk pipelines (uniform-length and ONT length-lognormal fixtures, each
for sketching and whole-file counting) with per-phase breakdowns
{ingest_wait, dispatch, sync, finalize}.  Every timing ends in
``jax.block_until_ready``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import kmerutils_tpu  # noqa: F401  (enables x64)
import jax

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_data")
BASELINE_MBASES_PER_S = 85.9  # 4.38 Gbases / 51 s (reference README.md:45)

K = 8
M = 200
READ_LEN = 6000       # FAB49164 mean read length ~5.9 kb
N_READS = 1024       # per batch
HEAVY_CAP = 1024  # legacy knob (kept for interface stability; kernel is exact)

_LUT = np.frombuffer(b"ACGT", np.uint8)

# ---------------------------------------------------------------------------
# budget + incremental emission
# ---------------------------------------------------------------------------

_T0 = time.monotonic()
BUDGET_S = float(os.environ.get("KMERUTILS_BENCH_BUDGET_S", "1140"))


def _remaining() -> float:
    return BUDGET_S - (time.monotonic() - _T0)


OUT = {
    "metric": "probminhash_sketch_throughput_k8_m200",
    "value": 0.0,
    "unit": "Mbases/s",
    "vs_baseline": 0.0,
    "extra": {"budget_s": BUDGET_S},
}
_FAILED: list = []


def _emit():
    OUT["extra"]["elapsed_s"] = round(time.monotonic() - _T0, 1)
    print(json.dumps(OUT), flush=True)


def _section(name: str, est_s: float, fn):
    """Run one bench section under the budget.  Records either the
    section's results (fn mutates OUT), {"skipped": "budget"} when the
    remaining wall cannot plausibly cover a cold run, or the error string
    if the section raises — then re-emits the cumulative record."""
    if _remaining() < est_s:
        OUT["extra"][name] = {"skipped": "budget"}
        _emit()
        return False
    t0 = time.monotonic()
    try:
        fn()
        ok = True
    except Exception as e:  # record it, run the rest, fail at exit
        OUT["extra"][name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        _FAILED.append(name)
        ok = False
    OUT["extra"].setdefault(name, {})
    if isinstance(OUT["extra"][name], dict):
        OUT["extra"][name]["section_wall_s"] = round(time.monotonic() - t0, 1)
    _emit()
    return ok


# ---------------------------------------------------------------------------
# device-side sections
# ---------------------------------------------------------------------------

def make_batch(rng):
    from kmerutils_tpu.base.sequence import pack_codes
    codes = rng.integers(0, 4, size=(N_READS, READ_LEN), dtype=np.uint8)
    lengths = np.full(N_READS, READ_LEN, dtype=np.int32)
    return pack_codes(codes, lengths)


def step(words, lengths):
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.sketch.jaccard import hashed_kmers
    from kmerutils_tpu.sketch import probminhash
    batch = ReadBatch(words=words, lengths=lengths)
    items, valid = hashed_kmers(batch, K)
    sig, _, ovf = probminhash.probminhash_from_items(
        items, valid, M, heavy_cap=HEAVY_CAP)
    return sig, ovf


def bench_sketch(rng):
    batch = make_batch(rng)
    jstep = jax.jit(step)
    sig, ovf = jstep(batch.words, batch.lengths)       # compile + warm up
    assert not bool(np.asarray(ovf).any()), "heavy_cap overflow in bench"

    n_iter = 20
    t0 = time.perf_counter()
    for _ in range(n_iter):
        sig, _ = jstep(batch.words, batch.lengths)
    jax.block_until_ready(sig)
    dt = (time.perf_counter() - t0) / n_iter
    return N_READS * READ_LEN / dt / 1e6


def bench_sketch_device(rng):
    """DEVICE-attributed flagship rate via loop-count scaling: kk chained
    perturbed steps inside ONE jitted fori_loop; (T(k2)-T(k1))/(k2-k1)
    cancels dispatch and sync, so a kernel regression reads apart from
    host-side dispatch cost."""
    import functools
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.sketch.jaccard import hashed_kmers
    from kmerutils_tpu.sketch import probminhash
    import jax.numpy as jnp

    batch = make_batch(rng)

    @functools.partial(jax.jit, static_argnames=("kk",))
    def steps(words, lengths, kk: int):
        def body(i, acc):
            w = words ^ (jnp.uint32(0x9E3779B9) * i.astype(jnp.uint32))
            items, valid = hashed_kmers(
                ReadBatch(words=w, lengths=lengths), K)
            sig, _, _ = probminhash.probminhash_from_items(
                items, valid, M, heavy_cap=HEAVY_CAP)
            return acc ^ sig
        return jax.lax.fori_loop(
            0, kk, body, jnp.zeros((words.shape[0], M), jnp.uint32))

    k1, k2 = 2, 10
    for kk in (k1, k2):
        jax.block_until_ready(steps(batch.words, batch.lengths, kk))

    def run(kk):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(steps(batch.words, batch.lengths, kk))
            best = min(best, time.perf_counter() - t0)
        return best

    dt = (run(k2) - run(k1)) / (k2 - k1)
    return N_READS * READ_LEN / dt / 1e6


def bench_stream_count(rng):
    """Device-side streaming counting rate (kmers/s and Mbases/s) through
    the merge-fold table.  Synthetic genome-with-coverage batches
    (so folds see realistic duplicate mixes), batch shape = the CLI's
    quantized 1024x8192, table in the CLI's `--count` large-file
    configuration (no coords, 2^28 capacity => LSM staging depth 2)."""
    from kmerutils_tpu.base.sequence import pack_codes
    from kmerutils_tpu.count import stream

    K = 16
    genome = rng.integers(0, 4, size=20 << 20, dtype=np.uint8)  # 20 Mbase
    n_reads, rl = 1024, 8192
    starts = rng.integers(0, genome.size - rl, size=n_reads)
    codes = np.stack([genome[s : s + rl] for s in starts])
    batch = pack_codes(codes, np.full(n_reads, rl, np.int32))

    cap = 1 << 28
    prep = jax.jit(stream.batch_entries, static_argnames=("k", "coords"))
    # warmup: one full staged cycle (compiles prep, both stage-merge
    # shapes, the fold, and its compact branch)
    folder = stream.StagedFolder(
        stream.StreamCountTable.create(cap, wide=False, coords=False))
    for i in range(1 << folder.depth):
        arrs, live = prep(batch, k=K, read_num_offset=i * n_reads,
                          coords=False)
        folder.push(arrs, live)
    jax.block_until_ready(folder.flush().arrs)

    folder = stream.StagedFolder(
        stream.StreamCountTable.create(cap, wide=False, coords=False))
    n_iter = 3 * (1 << folder.depth)      # whole staged cycles
    t0 = time.perf_counter()
    off = 0
    pending = []          # lag-1 sync per fold (the CLI's hint-fetch
    #                       pattern): bounds queued fold outputs in HBM
    for _ in range(n_iter):
        arrs, live = prep(batch, k=K, read_num_offset=off, coords=False)
        if folder.push(arrs, live):
            pending.append(folder.table.used)
            if len(pending) > 1:
                jax.block_until_ready(pending.pop(0))
        off += n_reads
    tbl = folder.flush()
    jax.block_until_ready(tbl.arrs)
    dt = (time.perf_counter() - t0) / n_iter
    used = int(np.asarray(tbl.used))
    assert used > 0
    kmers = n_reads * (rl - K + 1)
    return kmers / dt / 1e6, n_reads * rl / dt / 1e6


# ---------------------------------------------------------------------------
# fixtures (generated once, cached in the checkout's .bench_data/)
# ---------------------------------------------------------------------------

def _write_fastq(path, seqs):
    """seqs: iterable of bytes rows; buffered vectorized-ish writer."""
    with open(path, "wb") as f:
        parts = []
        for i, s in enumerate(seqs):
            parts += [b"@r%d\n" % i, s, b"\n+\n", b"I" * len(s), b"\n"]
            if len(parts) >= 4096:
                f.write(b"".join(parts))
                parts = []
        f.write(b"".join(parts))


def _fixture(path, make, min_bytes):
    os.makedirs(DATA_DIR, exist_ok=True)
    if not (os.path.exists(path) and os.path.getsize(path) >= min_bytes):
        make()
    return path


def fixture_uniform(rng):
    """~770 MB coverage FASTQ: 384 Mbases of uniform 6 kb reads sampled
    from a 2 Mbase genome (~190x coverage).  Serves BOTH e2e workloads:
    per-read sketching is content-agnostic, and counting needs bounded
    distinct kmers (~2M) so the record down-transfer stays realistic.
    Sized so the pipeline's fixed costs (final sync RTTs, finalize
    aggregate+transfer) amortize and the metric reads steady-state
    throughput, not launch overhead."""
    n_reads, rl = 64000, 6000

    def make():
        genome = rng.integers(0, 4, size=2 << 20, dtype=np.uint8)
        starts = rng.integers(0, genome.size - rl, size=n_reads)
        _write_fastq(os.path.join(DATA_DIR, "cov_384m.fastq"),
                     (_LUT[genome[s : s + rl]].tobytes() for s in starts))

    return _fixture(os.path.join(DATA_DIR, "cov_384m.fastq"), make,
                    n_reads * rl * 2)


def fixture_ont(rng):
    """~800 MB ONT-realistic FASTQ: length-lognormal reads (median ~5 kb,
    heavy tail, clipped to [500, 16000]) sampled from a 2 Mbase genome —
    exercises the bucketing/padding path (io/fastx bucket=True) the
    uniform fixture cannot."""
    total = 384_000_000

    def make():
        genome = rng.integers(0, 4, size=2 << 20, dtype=np.uint8)
        lens = []
        acc = 0
        while acc < total:
            block = np.clip(rng.lognormal(np.log(5000), 0.85, size=4096),
                            500, 16000).astype(np.int64)
            lens.extend(int(x) for x in block)
            acc += int(block.sum())
        starts = rng.integers(0, genome.size - 16000, size=len(lens))

        def rows():
            for s, ln in zip(starts, lens):
                yield _LUT[genome[s : s + ln]].tobytes()

        _write_fastq(os.path.join(DATA_DIR, "ont_384m.fastq"), rows())

    return _fixture(os.path.join(DATA_DIR, "ont_384m.fastq"), make,
                    int(total * 1.9))


# ---------------------------------------------------------------------------
# end-to-end pipelines with phase breakdowns
# ---------------------------------------------------------------------------

_SHAPE_CACHE: dict = {}


def _file_shapes(path, bucket):
    """One host-only parse pass recording the batch shapes a file yields —
    shared by the sketch and count warmups on the same fixture so shape
    discovery is paid once, and reported as n_shapes in the phases (the
    rung-compile cost made visible)."""
    from kmerutils_tpu.io import fastx
    key = (path, bucket)
    if key not in _SHAPE_CACHE:
        shapes = []
        seen = set()
        for batch, _ in fastx.read_batches(path, bucket=bucket,
                                           to_host=True):
            s = batch.words.shape
            if s not in seen:
                seen.add(s)
                shapes.append(s)
        _SHAPE_CACHE[key] = shapes
    return _SHAPE_CACHE[key]


def e2e_sketch(path, bucket):
    """On-disk FASTQ -> per-read signatures, host ingest overlapped with
    device compute.  Returns (Mbases/s, phases dict)."""
    from kmerutils_tpu.io import fastx
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.sketch.jaccard import Sketcher
    from kmerutils_tpu.sketch.params import (SeqSketcherParams, SketchAlgo,
                                             DataType)

    params = SeqSketcherParams(kmer_size=K, sketch_size=M,
                               algo=SketchAlgo.PROB3A, data_t=DataType.DNA)
    sk = Sketcher(params=params)
    # warmup compile on every batch SHAPE this file produces (shape list
    # from one shared host-only pass; device-created dummy batches compile
    # the same programs with no host->device transfer).  Shapes compile
    # concurrently on a small thread pool.
    shapes = _file_shapes(path, bucket)
    import jax.numpy as jnp
    import concurrent.futures as cf

    def warm(s):
        zb = ReadBatch(words=jnp.zeros(s, jnp.uint32),
                       lengths=jnp.full(s[0], (s[1] - 1) * 16, jnp.int32))
        jax.block_until_ready(sk.sketch_batch(zb))

    with cf.ThreadPoolExecutor(min(4, max(1, len(shapes)))) as ex:
        list(ex.map(warm, shapes))

    t0 = time.perf_counter()
    st = fastx.IngestStats()
    up_bytes = 0
    t_wait = t_disp = 0.0
    last = None
    t = t0
    # default 10000-read batches (the datasketcher CLI's pack size)
    for batch, idx in fastx.read_batches_overlapped(
            path, stats=st, bucket=bucket, to_device=True):
        t2 = time.perf_counter(); t_wait += t2 - t
        up_bytes += batch.words.nbytes + batch.lengths.nbytes
        last = sk.sketch_batch(batch)
        t = time.perf_counter(); t_disp += t - t2
    t3 = time.perf_counter()
    jax.block_until_ready(last)
    t_sync = time.perf_counter() - t3
    dt = time.perf_counter() - t0
    phases = {"ingest_wait_s": round(t_wait, 3),
              "dispatch_s": round(t_disp, 3),
              "final_sync_s": round(t_sync, 3),
              "total_s": round(dt, 3),
              "up_mb": round(up_bytes / 1e6, 1),
              "n_shapes": len(shapes)}
    return st.n_bases / dt / 1e6, phases


def e2e_count(path, bucket, cap=1 << 26):
    """On-disk FASTQ -> whole-file exact counts through the streaming
    table (the `parsefastq --count` pipeline), ingest overlapped.
    Returns (Mbases/s, phases dict)."""
    from kmerutils_tpu.io import fastx
    from kmerutils_tpu.base.sequence import ReadBatch
    from kmerutils_tpu.count import stream

    K = 16
    prep = jax.jit(stream.batch_entries, static_argnames=("k", "coords"))
    # warmup compile on every batch SHAPE + the finalize program (cold,
    # its aggregate graph compiles INSIDE the timed region otherwise)
    folder = stream.StagedFolder(
        stream.StreamCountTable.create(cap, wide=False, coords=False))
    shapes = _file_shapes(path, bucket)
    import jax.numpy as jnp
    for s in shapes:
        zb = ReadBatch(words=jnp.zeros(s, jnp.uint32),
                       lengths=jnp.full(s[0], (s[1] - 1) * 16, jnp.int32))
        arrs, live = prep(zb, k=K, read_num_offset=0, coords=False)
        folder.push(arrs, live)
    stream.finalize(folder.flush(), min_count=2, count_clamp=255)
    folder = stream.StagedFolder(
        stream.StreamCountTable.create(cap, wide=False, coords=False))

    t0 = time.perf_counter()
    st = fastx.IngestStats()
    pending = []
    n_folds = 0
    up_bytes = 0
    t_wait = t_disp = t_sync = 0.0
    t = t0
    for batch, idx in fastx.read_batches_overlapped(path, stats=st,
                                                    bucket=bucket,
                                                    to_device=True):
        t2 = time.perf_counter(); t_wait += t2 - t
        up_bytes += batch.words.nbytes + batch.lengths.nbytes
        arrs, live = prep(batch, k=K, read_num_offset=0, coords=False)
        s0 = 0.0
        if folder.push(arrs, live):
            # capacity is fixed here (no grow hints to sample); table
            # buffers are DONATED through folds, and an occasional lagged
            # sync bounds the queued prep outputs (~50 MB/batch) in device
            # memory
            n_folds += 1
            pending.append(folder.table.used)
            if n_folds % 32 == 0:
                t4 = time.perf_counter()
                jax.block_until_ready(pending.pop(0))
                pending = pending[-1:]
                s0 = time.perf_counter() - t4
                t_sync += s0
        t = time.perf_counter(); t_disp += t - t2 - s0
    t5 = time.perf_counter()
    # split the tail: drain = queued folds completing on device, then
    # finalize's own aggregate and record transfer are timed inside
    # stream.finalize via `phases`
    tbl = folder.flush()
    jax.block_until_ready(tbl.arrs)
    t_drain = time.perf_counter() - t5
    fin_ph: dict = {}
    # count_clamp=255 matches the CLI's default counter_size=8 dump
    # (saturating u8 counts, kmercount.rs counter_size) and ships counts
    # at 1 byte/record — the record transfer is finalize's main cost
    keys, counts, _, _, dropped = stream.finalize(tbl, min_count=2,
                                                  count_clamp=255,
                                                  phases=fin_ph)
    t_final = time.perf_counter() - t5
    dt = time.perf_counter() - t0
    assert len(keys) > 0
    down_mb = (len(keys) * 3 + 16384 * 8) / 1e6  # d16+cnt+exception list
    phases = {"ingest_wait_s": round(t_wait, 3),
              "dispatch_s": round(t_disp, 3),
              "sync_s": round(t_sync, 3),
              "finalize_s": round(t_final, 3),
              "drain_s": round(t_drain, 3),
              "agg_s": round(fin_ph.get("agg_s", 0.0), 3),
              "xfer_s": round(fin_ph.get("xfer_s", 0.0), 3),
              "total_s": round(dt, 3),
              "up_mb": round(up_bytes / 1e6, 1),
              "down_mb": round(down_mb, 1),
              "records": len(keys),
              "dropped": int(dropped),
              "n_shapes": len(shapes)}
    return st.n_bases / dt / 1e6, phases


def bench_aa_sketch(rng):
    """AA (5-bit) ProbMinHash rate in M amino acids/s — the
    SeqSketcherAAT twin path (aa/kmeraa.py; reference
    aautils/setsketchert.rs:78-203).  Synthetic 1024 x 2048-aa batch,
    k=6 (KmerAA32bit regime), m=200."""
    from kmerutils_tpu.aa.kmeraa import AABatch, SketcherAA
    from kmerutils_tpu.sketch.params import (SeqSketcherParams, SketchAlgo,
                                             DataType)
    import jax.numpy as jnp

    n, L = 1024, 2048
    codes = rng.integers(1, 21, size=(n, L), dtype=np.uint8)  # 20 AAs, 1-based
    batch = AABatch(codes=jnp.asarray(codes),
                    lengths=jnp.full(n, L, jnp.int32))
    sk = SketcherAA(params=SeqSketcherParams(
        kmer_size=6, sketch_size=M, algo=SketchAlgo.PROB3A,
        data_t=DataType.AA))
    jstep = jax.jit(sk.sketch_batch)
    jax.block_until_ready(jstep(batch))
    n_iter = 10
    t0 = time.perf_counter()
    for _ in range(n_iter):
        sig = jstep(batch)
    jax.block_until_ready(sig)
    dt = (time.perf_counter() - t0) / n_iter
    return n * L / dt / 1e6


def bench_hll_collection(rng):
    """Whole-collection SetSketch/HLL rate (Mbases/s): ONE mergeable
    signature for a full batch — the reference's block-merge workload
    (sketch_compressedkmer_seqs, setsketchert.rs:811-895; across a mesh
    the per-read register merge is a jax.lax.pmax)."""
    from kmerutils_tpu.sketch.jaccard import Sketcher
    from kmerutils_tpu.sketch.setsketch import SetSketchParams
    from kmerutils_tpu.sketch.params import (SeqSketcherParams, SketchAlgo,
                                             DataType)
    batch = make_batch(rng)
    sk = Sketcher(params=SeqSketcherParams(
        kmer_size=K, sketch_size=4096, algo=SketchAlgo.HLL,
        data_t=DataType.DNA), setsketch_params=SetSketchParams(m=4096))
    jstep = jax.jit(sk.sketch_collection)
    jax.block_until_ready(jstep(batch))
    n_iter = 10
    t0 = time.perf_counter()
    for _ in range(n_iter):
        sig = jstep(batch)
    jax.block_until_ready(sig)
    dt = (time.perf_counter() - t0) / n_iter
    return N_READS * READ_LEN / dt / 1e6


# ---------------------------------------------------------------------------
# section wiring
# ---------------------------------------------------------------------------

def card_name() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out[0] if out else "nvidia-smi printed nothing"


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX reports {dev.platform}); refusing to "
              "run", file=sys.stderr)
        return 1
    rng = np.random.default_rng(42)
    ex = OUT["extra"]
    ex["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices()), "card": card_name()}
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}; card: {ex['device']['card']}",
          flush=True)

    def sec_sketch():
        mb = bench_sketch(rng)
        OUT["value"] = round(mb, 2)
        OUT["vs_baseline"] = round(mb / BASELINE_MBASES_PER_S, 3)

    def sec_sketch_device():
        ex["sketch_device_mbases_s"] = round(bench_sketch_device(rng), 2)

    def sec_stream_count():
        mk, mb = bench_stream_count(rng)
        ex["stream_count_mkmers_s"] = round(mk, 2)
        ex["stream_count_mbases_s"] = round(mb, 2)

    def sec_aa_sketch():
        ex["aa_sketch_maa_s"] = round(bench_aa_sketch(rng), 2)

    def sec_hll_collection():
        ex["hll_collection_mbases_s"] = round(bench_hll_collection(rng), 2)

    # e2e sections: fixture generation is itself budget-gated
    def sec_e2e_sketch():
        mb, ph = e2e_sketch(fixture_uniform(rng), bucket=False)
        ex["e2e_file_sketch_mbases_s"] = round(mb, 2)
        ex["e2e_vs_baseline"] = round(mb / BASELINE_MBASES_PER_S, 3)
        ex["e2e_sketch_phases"] = ph

    def sec_e2e_count():
        mb, ph = e2e_count(fixture_uniform(rng), bucket=False)
        ex["e2e_file_count_mbases_s"] = round(mb, 2)
        ex["e2e_count_phases"] = ph

    def sec_ont_sketch():
        mb, ph = e2e_sketch(fixture_ont(rng), bucket=True)
        ex["ont_file_sketch_mbases_s"] = round(mb, 2)
        ex["ont_sketch_phases"] = ph

    def sec_ont_count():
        mb, ph = e2e_count(fixture_ont(rng), bucket=True)
        ex["ont_file_count_mbases_s"] = round(mb, 2)
        ex["ont_count_phases"] = ph

    # est_s = minimum plausible remaining cost (warm-cache wall + margin);
    # a cold-cache run can still exceed these, but each section's failure
    # mode is then a truncated tail, not an empty record.
    _section("sketch", 60, sec_sketch)
    _section("sketch_device", 60, sec_sketch_device)
    _section("stream_count", 120, sec_stream_count)
    _section("aa_sketch", 60, sec_aa_sketch)
    _section("hll_collection", 60, sec_hll_collection)
    _section("e2e_sketch", 120, sec_e2e_sketch)
    _section("e2e_count", 150, sec_e2e_count)
    _section("ont_sketch", 180, sec_ont_sketch)
    _section("ont_count", 180, sec_ont_count)
    if _FAILED:
        print(f"bench.py: sections failed: {', '.join(_FAILED)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
