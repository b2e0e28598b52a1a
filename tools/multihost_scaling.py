"""1-process vs 2-process CPU-mesh throughput of the PRODUCTION streaming
count path — the testable slice of BASELINE's >= 80% 2-host scaling target
(the process boundary on the 8-device CPU mesh plays the inter-host role,
exactly like tests/test_multihost.py).

Runs the same ShardedStreamCounter workload (exchange + staged folds)
over one 8-device mesh owned by 1 process and by 2 processes (4 devices
each), prints Mkmers/s for both and the ratio.

What the ratio MEANS here: the box has ONE physical core, so the 2-process
run cannot be faster in wall clock — both configurations execute the same
global work on the same core.  ratio = T1/T2 therefore isolates the
OVERHEAD the process/DCN boundary adds to the production path
(distributed dispatch, cross-process collectives); >= 0.8 means the
boundary costs < 25% on a compute-dominated stream, which is the
single-machine-testable component of the BASELINE 2-host claim (the rest
— real inter-host bandwidth — needs a second host).

The workload is sized to be COMPUTE-dominated (small batches measure
per-call dispatch, not throughput): 512 reads x 2048 b per batch sampled
from a 100 kb genome (bounded ~100k distinct 13-mers -> zero drops at
1<<16/device, realistic duplicate mixes in every fold).

It prints markdown rows for a results table.

Usage:  PYTHONPATH=. python tools/multihost_scaling.py
        (spawns its own workers)

Worker mode (internal): multihost_scaling.py worker <pid> <nproc> <port>
"""

import os
import socket
import subprocess
import sys
import time

N_DEV = 8
N_BATCH = 6           # timed updates
N_READS = 512         # reads per batch (global)
READ_LEN = 2048
GENOME = 100_000      # distinct-kmer bound ~ genome size (no drops)
K = 13


def worker(pid: int, nproc: int, port: str):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{N_DEV // nproc}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}", num_processes=nproc,
            process_id=pid)
    assert jax.device_count() == N_DEV

    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import kmerutils_tpu  # noqa: F401
    from kmerutils_tpu.base.sequence import pack_codes, ReadBatch
    from kmerutils_tpu.parallel import stream as pstream
    from kmerutils_tpu.parallel.mesh import READS_AXIS

    mesh = Mesh(np.asarray(jax.devices()).reshape(N_DEV), (READS_AXIS,))
    sh = NamedSharding(mesh, P(READS_AXIS))
    rng = np.random.default_rng(5)      # same stream in every process
    genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)

    def make_gbatch():
        starts = rng.integers(0, GENOME - READ_LEN, size=N_READS)
        codes = np.stack([genome[s : s + READ_LEN] for s in starts])
        rb = pack_codes(codes, np.full(N_READS, READ_LEN, np.int32),
                        as_numpy=True)
        w, l = rb.words, rb.lengths
        lo, hi = pid * (N_READS // nproc), (pid + 1) * (N_READS // nproc)
        if nproc > 1:
            return ReadBatch(
                words=jax.make_array_from_process_local_data(sh, w[lo:hi]),
                lengths=jax.make_array_from_process_local_data(
                    sh, l[lo:hi]))
        return ReadBatch(words=jax.device_put(w, sh),
                         lengths=jax.device_put(l, sh))

    batches = [make_gbatch() for _ in range(N_BATCH + 2)]
    # capacity pre-sized for the genome's distinct-kmer bound (no growth
    # will fire), so the hint reduce — the only cross-process sync besides
    # the per-batch exchange — is sampled once per stream, not per fold
    mk = lambda: pstream.ShardedStreamCounter(
        mesh, 1 << 16, wide=False, coords=False, depth=1,
        hint_every=N_BATCH)
    ctr = mk()
    # warmup: one full staged cycle + flush shapes
    for b in batches[:2]:
        ctr.update(b, K)
    ctr.flush()

    ctr = mk()
    import resource
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    off = 0
    for b in batches[2:]:
        ctr.update(b, K, read_num_offset=off)
        off += N_READS
    t = ctr.flush()
    import jax as _j
    _j.block_until_ready(t.arrs[0])
    dt = time.perf_counter() - t0
    kmers = N_BATCH * N_READS * (READ_LEN - K + 1)
    dropped = ctr.dropped_in_transit
    if not isinstance(dropped, int):
        # the accumulator is a GLOBAL array; sum the addressable shards
        # (drops are per-shard counts, so the global total is the sum of
        # every process's local sum — pid 0 reports its local view, 0 in
        # any correctly-capacity'd run)
        dropped = sum(int(np.asarray(s.data).sum())
                      for s in dropped.addressable_shards)
    ru = resource.getrusage(resource.RUSAGE_SELF)
    cpu_s = (ru.ru_utime + ru.ru_stime) - (ru0.ru_utime + ru0.ru_stime)
    # every process reports its CPU seconds (the parent sums them): on the
    # 1-core box WALL time under 2 processes is confounded by timesharing,
    # while total CPU-work is invariant — the boundary's true cost
    print(f"CPU {pid} {cpu_s:.2f}", flush=True)
    if pid == 0:
        print(f"RESULT {nproc}proc {kmers / dt / 1e6:.3f} Mkmers/s "
              f"({dt:.2f}s) local_dropped={dropped}", flush=True)
    if nproc > 1:
        jax.distributed.shutdown()


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(nproc: int) -> tuple[float, float]:
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(p),
         str(nproc), port],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)]
    rate = wall = None
    outs = []
    cpu_total = 0.0
    for p, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=3600)
        outs.append(out.decode(errors="replace"))
        assert pr.returncode == 0, f"worker {p}:\n{outs[-1]}"
    for o in outs:
        for line in o.splitlines():
            if line.startswith("CPU"):
                cpu_total += float(line.split()[2])
    for line in outs[0].splitlines():
        if line.startswith("RESULT"):
            rate = float(line.split()[2])
            wall = float(line.split()[4].strip("()s"))
    assert rate is not None, outs[0]
    return rate, wall, cpu_total


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    r1, w1, c1 = run(1)
    print(f"1-process: {r1:.3f} Mkmers/s ({w1:.1f}s wall, {c1:.1f} CPU-s)",
          flush=True)
    r2, w2, c2 = run(2)
    print(f"2-process: {r2:.3f} Mkmers/s ({w2:.1f}s wall, {c2:.1f} CPU-s "
          f"total)", flush=True)
    print(f"wall ratio (2proc/1proc): {r2 / r1:.3f}  "
          f"(confounded: 1 physical core timeshares both processes)",
          flush=True)
    print(f"CPU-work ratio (c1/c2):   {c1 / c2:.3f}  "
          f"(boundary's true added work; target >= 0.8)", flush=True)
    kmers = N_BATCH * N_READS * (READ_LEN - K + 1) / 1e6
    print("\nmarkdown rows:")
    print(f"| 1 process x 8 devices | {r1:.3f} Mkmers/s | {w1:.1f} s wall |"
          f" {c1:.1f} CPU-s |")
    print(f"| 2 processes x 4 devices | {r2:.3f} Mkmers/s | {w2:.1f} s wall"
          f" | {c2:.1f} CPU-s |")
    print(f"| CPU-work ratio | {c1 / c2:.3f} | target >= 0.8 | wall ratio "
          f"{r2 / r1:.3f} (1-core timeshare) |")
    print(f"(workload: {N_BATCH} batches x {N_READS} reads x {READ_LEN} b"
          f" = {kmers:.1f} Mkmers, genome {GENOME // 1000} kb, k={K})")


if __name__ == "__main__":
    main()
