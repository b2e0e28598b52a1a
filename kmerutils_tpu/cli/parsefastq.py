"""parsefastq CLI — base statistics + kmer counting / unicity.

Capability twin of /root/reference/src/bin/parsefastq.rs:45-256, same flag
vocabulary:

    parsefastq -f <file> [-b nb_bits] kmer (--count | --unique)
               [-s kmer_size] [-t n_threads] [-c counter_size]
    parsefastq -f <file> ret -b <base>

Always computes base/readlen statistics ("bases.histo", "readlen.histo",
statutils.rs dumps).  Counting writes <file>.multi_kmer.bin in the
reference's multiple-kmer format; unicity writes <file>.once_kmer.bin with
coordinates.  ``-t`` is accepted for interface parity (device batching
replaces host threads).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="parsefastq")
    p.add_argument("-f", "--file", required=True, dest="filename")
    p.add_argument("-b", "--bits", type=int, default=2, dest="nb_bits",
                   help="bits per base for in-memory packing (2|4|8)")
    p.add_argument("--batch-reads", type=int, default=10000)
    sub = p.add_subparsers(dest="cmd")
    km = sub.add_parser("kmer", help="kmer counting")
    g = km.add_mutually_exclusive_group(required=True)
    g.add_argument("--count", action="store_true")
    g.add_argument("--unique", action="store_true")
    km.add_argument("-s", "--size", type=int, default=16, dest="kmer_size")
    km.add_argument("-t", "--threads", type=int, default=1,
                    help="accepted for parity; batching replaces threads")
    km.add_argument("-c", "--counter", type=int, default=8, dest="counter_size",
                    help="bits per count in the dump (8 or 16)")
    km.add_argument("--capacity", type=int, default=0,
                    help="device count-table capacity in entries (the "
                         "reference's cuckoo capacity role, "
                         "kmercount.rs:297-307); 0 = size from the file")
    km.add_argument("--no-spill", action="store_true",
                    help="disable host spill segments; past-capacity "
                         "entries drop (largest keys) with a warning, like "
                         "the reference's capacity-bounded cuckoo.  Default "
                         "is exact counting at any cardinality via disk "
                         "spill (count/spill.py)")
    ret = sub.add_parser("ret", help="return times (reserved)")
    ret.add_argument("-b", "--base", type=str, default="A")
    return p


def _auto_capacity(filename: str, coords: bool) -> int:
    """Size the count table from the file: distinct kmers <= total kmers
    ~ bases ~ half the FASTQ byte size (quality lines + headers are the
    other half; gz estimated at 2.5x expansion).  Clamp to [2^20, cap_max]
    entries (cap_max bounded by HBM: 2 words/entry without coordinates,
    4 with) and add 50% headroom for pending duplicate entries — overflow
    drops largest keys with a warning, exactly like the reference's
    capacity-bounded cuckoo (kmercount.rs:297-307)."""
    import os
    size = os.path.getsize(filename)
    if filename.endswith(".gz"):
        size = int(size * 2.5)
    est_kmers = max(size // 2, 1)
    cap_max = 27 if coords else 28          # ~2.1 GB of HBM either way
    return 1 << max(20, min(cap_max, (int(est_kmers * 1.5) - 1).bit_length()))


def main(argv=None):
    import kmerutils_tpu  # noqa: F401
    from ..io import fastx
    from ..io import formats
    from .. import stats

    args = build_parser().parse_args(argv)
    t0 = time.time()
    st = fastx.IngestStats()
    dist = stats.ReadBaseDistribution.new()

    if args.cmd == "kmer":
        k = args.kmer_size
        if k == 15 or k > 32:
            print(f"kmer size {k} unsupported (14-max u32 / 16 / 17..32)",
                  file=sys.stderr)
            return 1
        import jax
        from ..count import stream
        # device-resident streaming accumulation: each batch is ONE merge
        # fold (count/stream.py); records transfer to host once.
        # --unique needs first-occurrence coordinates; --count does not
        # (the multiple-kmer dump is reloaded into a map, kmercount.rs:1291)
        # and runs ~2x faster without the two coordinate words
        coords = not args.count
        cap_max = args.capacity or _auto_capacity(args.filename, coords)
        # start small and GROW toward cap_max only when needed (saves HBM
        # when the file is mostly duplicates; folds themselves cost
        # O(occupancy), not capacity).  The trigger is the table's own
        # grow_hint — raised on DEVICE right after a compaction, when the
        # fresh DISTINCT count is within the fold headroom of capacity
        # (plain `used` is inflated by pending duplicates and would grow
        # spuriously; the headroom covers the lag-1 host fetch, so growth
        # lands before any fold can drop — stream.fold).  Batches are
        # staged through binary-counter merges (stream.StagedFolder) so
        # the table's O(occupancy) re-read amortizes over 2^depth batches
        capacity = min(cap_max, 1 << 26)
        folder = stream.StagedFolder(
            stream.StreamCountTable.create(capacity, wide=k > 16,
                                           coords=coords))
        prep = jax.jit(stream.batch_entries,
                       static_argnames=("k", "coords"))
        spill_store = None
        if not getattr(args, "no_spill", False):
            from ..count import spill as spill_mod
        offset = 0
        pending: list = []   # backpressure: bound the async dispatch depth
        # --count may length-bucket (rung-pure batches, less padding on
        # ONT-like length mixes); --unique must NOT: its coordinates are
        # assigned row-major from read_num_offset, which requires batch
        # rows in file order
        for batch, idx in fastx.read_batches_overlapped(
                args.filename, batch_reads=args.batch_reads,
                stats=st, bucket=bool(args.count), to_device=True):
            dist.record_batch(batch)
            arrs, live = prep(batch, k=k, read_num_offset=offset,
                              coords=coords)
            folded = folder.push(arrs, live)
            offset += len(idx)  # real reads only (batch may be shape-padded)
            if not folded:
                continue
            pending.append(folder.table.grow_hint)
            if len(pending) > 1:
                # host fetch of a scalar from the PREVIOUS fold: double
                # buffering (device runs fold i while we read fold i-1's
                # hint — the growth decision needs its value).  Lag 1
                # keeps the drop-safety
                # margin: a hint fires with >= 3 folds of post-compact
                # slack (stream.fold sizes the headroom from the fold's
                # own static input size) and the worst case consumes them
                # all before growth/spill lands
                hint = int(np.asarray(pending.pop(0)))
                if hint:
                    if capacity < cap_max:
                        capacity = min(capacity * 8, cap_max)
                        folder.table = stream.grow(folder.table, capacity)
                        # hints still queued were computed against the OLD
                        # capacity; acting on them would ladder straight to
                        # cap_max / a spurious spill
                        pending.clear()
                    elif not getattr(args, "no_spill", False):
                        # growth ladder topped out: ship the table's
                        # aggregated runs to a disk segment and restart
                        # empty — exact at any cardinality (count/spill.py)
                        if spill_store is None:
                            spill_store = spill_mod.SpillStore(
                                wide=k > 16, coords=coords)
                        folder.table = spill_store.spill_table(folder.table)
                        pending.clear()
        table = folder.flush()
        bpc = 1 if args.counter_size <= 8 else 2
        if spill_store is not None and spill_store.n_segments:
            # spill epochs happened: final table joins them as one more
            # segment; the k-way merge re-aggregates across epochs in
            # bounded memory (count/spill.py) — exact at any cardinality
            spill_store.spill_table(table)
            dropped = spill_store.n_dropped
            if args.count:
                out = args.filename + ".multi_kmer.bin"
                with formats.MultipleKmerDumpWriter(out, k, bpc) as w:
                    for mk, mc, _mr, _mp in spill_store.merge_stream():
                        w.write(mk, mc)
                print(f"dumped {w.n} multiple kmers to {out} "
                      f"({spill_store.n_segments} spill segments merged)")
            else:
                uk, ur, up = [], [], []
                for mk, mc, mr, mp in spill_store.merge_stream():
                    sel = mc == 1
                    uk.append(mk[sel])
                    ur.append(mr[sel])
                    up.append(mp[sel])
                keys = np.concatenate(uk)
                frn = np.concatenate(ur)
                fps = np.concatenate(up)
                order = np.argsort((frn.astype(np.uint64) << np.uint64(32))
                                   | fps, kind="stable")  # scan order
                out = args.filename + ".once_kmer.bin"
                formats.write_unique_kmer_dump(out, k, keys[order],
                                               frn[order], fps[order])
                print(f"dumped {len(keys)} unique kmers to {out} "
                      f"({spill_store.n_segments} spill segments merged)")
            spill_store.close()
        else:
            if args.count:
                keys, counts, frn, fps, dropped = stream.finalize(
                    table, min_count=2,
                    count_clamp=(1 << (8 * bpc)) - 1)
            else:
                keys, counts, frn, fps, dropped = stream.finalize(table, 1, 1)
            if args.count:
                # records in ascending canonical-kmer order (reload builds a
                # map; the reference's own dump order is channel-arbitrary,
                # kmercount.rs:756-770)
                out = args.filename + ".multi_kmer.bin"
                n = formats.write_multiple_kmer_dump(
                    out, k, keys, counts, bytes_per_count=bpc)
                print(f"dumped {n} multiple kmers to {out}")
            else:
                order = np.argsort((frn.astype(np.uint64) << np.uint64(32))
                                   | fps, kind="stable")  # scan order
                out = args.filename + ".once_kmer.bin"
                formats.write_unique_kmer_dump(out, k, keys[order],
                                               frn[order], fps[order])
                print(f"dumped {len(keys)} unique kmers to {out}")
        if dropped:
            print(f"WARNING: {dropped} entries dropped past capacity "
                  f"{capacity} (raise --capacity or drop --no-spill)",
                  file=sys.stderr)
    else:
        for batch, idx in fastx.read_batches(args.filename,
                                             batch_reads=args.batch_reads,
                                             stats=st, bucket=False):
            dist.record_batch(batch)

    dist.non_acgt = st.nb_bad_bases
    dist.ascii_dump_acgt_distribution("bases.histo")
    try:
        dist.ascii_dump_readlen_distribution("readlen.histo")
    except ValueError:
        pass
    print(f"reads: {st.n_reads}  bases: {st.n_bases}  "
          f"bad reads dropped: {st.nb_bad_read}  elapsed: {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
