"""Worker process for the 2-process multi-host dryrun (tests/test_multihost.py).

Each process owns 4 virtual CPU devices; jax.distributed stitches them into
one 8-device global mesh spanning a process (≈ host/DCN) boundary.  The
worker drives, across that boundary: the hash-routed all_to_all counting
step (collective.sharded_count), the signature all-gather
(collective.gather_signatures), and the PRODUCTION streaming path
(parallel/stream.ShardedStreamCounter — merge-fold tables with LSM
staging) over >=3 batches at both key widths with coordinates on, each
verified against a replicated host oracle — plus one forced GROWTH epoch
and one forced SPILL epoch of that production path (tiny caps), so the
ladder + disk-segment machinery is exercised across the 2-process
boundary too.  SURVEY.md §7 step 7's CPU-testable slice of the
multi-host story.

Usage: python multihost_worker.py <pid> <nproc> <coord_port> <out_dir>
"""

import os
import sys


def main():
    pid, nproc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)
    assert jax.device_count() == 4 * nproc, jax.devices()
    assert jax.local_device_count() == 4

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import kmerutils_tpu  # noqa: F401
    from kmerutils_tpu.base.sequence import pack_ascii_reads
    from kmerutils_tpu.parallel import collective
    from kmerutils_tpu.parallel.mesh import READS_AXIS
    from kmerutils_tpu.count import exact
    from kmerutils_tpu.sketch.jaccard import hashed_kmers
    from kmerutils_tpu.sketch import probminhash

    k = 13
    n_dev = jax.device_count()
    rng = np.random.default_rng(7)          # identical reads in all processes
    reads = ["".join(rng.choice(list("ACGT"), size=200)) for _ in range(n_dev)]
    batch = pack_ascii_reads(reads)
    words = np.asarray(batch.words)
    lengths = np.asarray(batch.lengths)

    mesh = Mesh(np.asarray(jax.devices()).reshape(n_dev), (READS_AXIS,))
    sh = NamedSharding(mesh, P(READS_AXIS))
    # each process contributes its local rows of the globally-sharded batch
    gwords = jax.make_array_from_process_local_data(sh, words[
        pid * (n_dev // nproc):(pid + 1) * (n_dev // nproc)])
    glengths = jax.make_array_from_process_local_data(sh, lengths[
        pid * (n_dev // nproc):(pid + 1) * (n_dev // nproc)])
    from kmerutils_tpu.base.sequence import ReadBatch
    gbatch = ReadBatch(words=gwords, lengths=glengths)

    # 1. hash-routed counting across the process boundary
    keys, counts, dropped, n_distinct, _ = collective.sharded_count(
        gbatch, k, mesh)
    from jax.experimental import multihost_utils
    all_keys = multihost_utils.process_allgather(keys, tiled=True)
    all_counts = multihost_utils.process_allgather(counts, tiled=True)
    assert int(np.asarray(multihost_utils.process_allgather(
        dropped, tiled=True)).sum()) == 0

    # oracle (replicated)
    import collections
    comp = str.maketrans("ACGT", "TGCA")
    oracle = collections.Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            s = r[i:i + k]
            oracle[min(s, s.translate(comp)[::-1])] += 1
    from kmerutils_tpu.base import kmer as kmer_mod
    want = {kmer_mod.kmer_value_from_str(s): c for s, c in oracle.items()}
    got = {}
    for row_k, row_c in zip(np.asarray(all_keys), np.asarray(all_counts)):
        sel = row_c > 0
        for kk, cc in zip(row_k[sel], row_c[sel]):
            got[int(kk)] = got.get(int(kk), 0) + int(cc)
    assert got == want, (len(got), len(want))

    # 2. signature all-gather across the boundary (ANN collection step)
    items, valid = hashed_kmers(gbatch, 8)
    m = 16

    def sk(it, va):
        sig, _, _ = probminhash.probminhash_from_items(it, va, m)
        return sig

    sigs = collective.data_parallel_sketch(sk, mesh)(items, valid)
    gathered = collective.gather_signatures(sigs, mesh)
    # oracle: single-device sketch of the full batch
    it_full, va_full = hashed_kmers(batch, 8)
    sig_full, _, _ = probminhash.probminhash_from_items(it_full, va_full, m)
    g_host = np.asarray(
        multihost_utils.process_allgather(gathered, tiled=True))
    # gather_signatures replicates; process_allgather of a replicated array
    # returns one copy per process — compare against the first
    g_host = g_host.reshape(-1, *sig_full.shape)[0]
    assert np.array_equal(g_host, np.asarray(sig_full))

    # 3. PRODUCTION streaming path across the boundary: ShardedStreamCounter
    # (merge-fold tables + LSM staging) over >= 3 batches at both key
    # widths with coordinates on.  Each process oracle-verifies the shards
    # it owns (the per-host view of the pool union, kmercount.rs:546-565).
    from kmerutils_tpu.parallel import stream as pstream
    from kmerutils_tpu.count import dispatch as disp_mod

    def make_gbatch(reads):
        rb = pack_ascii_reads(reads)
        w, l = np.asarray(rb.words), np.asarray(rb.lengths)
        lo, hi = pid * (n_dev // nproc), (pid + 1) * (n_dev // nproc)
        return ReadBatch(
            words=jax.make_array_from_process_local_data(sh, w[lo:hi]),
            lengths=jax.make_array_from_process_local_data(sh, l[lo:hi]))

    owned_rows = set(range(pid * (n_dev // nproc),
                           (pid + 1) * (n_dev // nproc)))

    def check_owned_shards(local, all_reads, kk_):
        """Per-shard oracle: counts + first-occurrence coords of the rows
        this process owns must equal the replicated host Counter."""
        assert set(local) == owned_rows, (set(local), owned_rows)
        oc = collections.Counter()
        first = {}
        for r, s in enumerate(all_reads):
            for i in range(len(s) - kk_ + 1):
                sub = s[i:i + kk_]
                v = kmer_mod.kmer_value_from_str(
                    min(sub, sub.translate(comp)[::-1]))
                oc[v] += 1
                first.setdefault(v, (r, i))
        sid_all = np.asarray(disp_mod.dispatch(
            jnp.asarray(np.fromiter(oc, np.uint64)), n_dev, kk_))
        want = {}
        for v, s_ in zip(oc, sid_all):
            if int(s_) in owned_rows:
                want[int(v)] = (oc[v],) + first[v]
        got = {}
        for r, (keys, counts, rn, ps, dropped) in local.items():
            assert dropped == 0
            if len(keys):
                sid = np.asarray(disp_mod.dispatch(
                    jnp.asarray(keys.astype(np.uint64)), n_dev, kk_))
                assert (sid == r).all()
            for v, c, r_, p_ in zip(keys.tolist(), counts.tolist(),
                                    rn.tolist(), ps.tolist()):
                got[int(v)] = (int(c), int(r_), int(p_))
        assert got == want, (kk_, len(got), len(want))

    for kk_, wide in ((13, False), (21, True)):
        rng2 = np.random.default_rng(11)    # same stream in every process
        ctr = pstream.ShardedStreamCounter(mesh, 1 << 12, wide=wide,
                                           coords=True, depth=1)
        all_reads, offset = [], 0
        for b in range(3):
            rr = ["".join(rng2.choice(list("ACGT"), size=160))
                  for _ in range(n_dev)]
            if b:
                rr[0] = all_reads[0]        # cross-batch duplicates
            all_reads.extend(rr)
            ctr.update(make_gbatch(rr), kk_, read_num_offset=offset)
            offset += len(rr)
        check_owned_shards(ctr.finalize_local(), all_reads, kk_)

    # 4. growth + spill epochs across the process boundary: tables start
    # too small (1<<11/device), the replicated lag-1 grow hint must step
    # the ladder (kmercount.rs:297-307 capacity role), and once topped out
    # (cap_max 1<<12) each process must spill ITS shards to disk segments;
    # the k-way merge in finalize_local restores exact counts + coords
    # (kmercount.rs:546-565 pool-union semantics).
    rng3 = np.random.default_rng(23)        # same stream in every process
    ctr = pstream.ShardedStreamCounter(
        mesh, 1 << 11, wide=False, coords=True,
        cap_max_per_device=1 << 12, depth=0, spill=True,
        spill_dir=out_dir)
    all_reads, offset = [], 0
    for b in range(14):
        rr = ["".join(rng3.choice(list("ACGT"), size=400))
              for _ in range(n_dev)]
        all_reads.extend(rr)
        ctr.update(make_gbatch(rr), 13, read_num_offset=offset)
        offset += len(rr)
    assert ctr.table.cap > (1 << 11), \
        "growth ladder never fired across the process boundary"
    local = ctr.finalize_local()
    assert ctr.spill_stores, \
        "spill never triggered across the process boundary"
    check_owned_shards(local, all_reads, 13)
    ctr.close()

    # 5. exchange-overflow accounting across the process boundary: a
    # deliberately tiny shard_cap_factor makes the all_to_all buckets
    # overflow; the reported global in-transit drop count (psum-reduced in
    # finalize_local) must equal generated - received exactly.
    rng4 = np.random.default_rng(31)        # same stream in every process
    ctr = pstream.ShardedStreamCounter(mesh, 1 << 12, wide=False,
                                       coords=False, depth=0,
                                       shard_cap_factor=0.1)
    kk_ = 13
    rr = ["".join(rng4.choice(list("ACGT"), size=4096))
          for _ in range(n_dev)]
    ctr.update(make_gbatch(rr), kk_)
    local = ctr.finalize_local()
    assert isinstance(ctr.dropped_in_transit, int)
    assert ctr.dropped_in_transit > 0, \
        "tiny shard_cap_factor produced no exchange overflow"
    generated = sum(len(s) - kk_ + 1 for s in rr)
    received_local = sum(int(v[1].sum()) for v in local.values())
    received = int(np.asarray(multihost_utils.process_allgather(
        jnp.asarray([received_local]), tiled=True)).sum())
    assert ctr.dropped_in_transit == generated - received, \
        (ctr.dropped_in_transit, generated, received)
    ctr.close()

    with open(os.path.join(out_dir, f"ok.{pid}"), "w") as f:
        f.write("ok")
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
