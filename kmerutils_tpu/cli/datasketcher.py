"""datasketcher CLI — per-read (or per-block) signatures + ANN export.

Capability twin of /root/reference/src/bin/datasketcher.rs:48-388, same flag
vocabulary:

    datasketcher -f <file> -s <sketch_size> -k <kmer_size> -d <dump>
                 [-b block_size] [-a algo] [ann -n nbng]

Streams the file in packs of reads (10000, or 5000 in block mode — the
reference's pack sizes, datasketcher.rs:212), sketches with ProbMinHash3a by
default (hash = invertible wang hash of the canonical kmer,
datasketcher.rs:222-226), writes the signature dump (magic 0xceabeadd) or
block dump (0xceabbadd), the params JSON, and optionally the ANN export
(the hnsw_rs role, datasketcher.rs:156-195): signatures go into the native
HNSW graph (kmerutils_tpu/hnsw.py -> native/hnsw.cpp), the graph is dumped
to <dump>-ann.hnsw and a neighbor table to <dump>-ann; --engine brute falls
back to the exact device-side search (ann.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="datasketcher")
    p.add_argument("-f", "--file", required=True, dest="filename")
    p.add_argument("-s", "--sketch", type=int, required=True, dest="sketch_size")
    p.add_argument("-k", "--kmer", type=int, required=True, dest="kmer_size")
    p.add_argument("-d", "--dump", required=True, dest="dumpfname")
    p.add_argument("-b", "--block", type=int, default=0, dest="block_size")
    p.add_argument("-a", "--algo", default="PROB3A",
                   choices=["PROB3A", "SUPER", "SUPER2", "OPTDENS",
                            "REVOPTDENS", "HLL"])
    sub = p.add_subparsers(dest="cmd")
    ann = sub.add_parser("ann")
    ann.add_argument("-n", "--nbng", type=int, default=10)
    ann.add_argument("--engine", default="hnsw", choices=["hnsw", "brute"],
                     help="hnsw = native graph index (+ graph file dump, "
                          "the hnsw_rs role); brute = exact device-side")
    ann.add_argument("--max-nb-connection", type=int, default=24,
                     help="HNSW max degree (reference default, "
                          "datasketcher.rs:169)")
    ann.add_argument("--ef", type=int, default=400,
                     help="HNSW ef_construction (datasketcher.rs:170)")
    return p


def _block_ann(args, per_seq):
    """ANN over BLOCK sketches — the Hnsw<BlockSketched, DistBlockSketched>
    role (datasketcher.rs:285-309): every live block is one vector; the
    same-read rule of DistBlockSketched (distance 1.0 within a read,
    seqblocksketch.rs:417-440) is applied by filtering same-read hits from
    the neighbor table.  Writes <dump>-ann (block-level neighbors),
    <dump>-ann.blocks ((numseq, numblock) u32 pairs, one per table row)
    and, with the native index, <dump>-ann.hnsw."""
    import numpy as np
    from ..ann import brute_force_neighbors, write_neighbor_dump
    from .. import hnsw as hnsw_mod

    rows = []
    who = []       # (numseq, numblock) per row
    for numseq, blocks in per_seq:
        for j, sig in enumerate(blocks):
            rows.append(sig)
            who.append((numseq, j))
    if not rows:
        print("no live blocks; skipping ann")
        return
    sigs = np.stack(rows).astype(np.uint32)
    who = np.asarray(who, dtype=np.uint32)
    read_of = who[:, 0].astype(np.int64)
    k = args.nbng
    extra = 8  # headroom so same-read filtering still leaves k hits
    if hnsw_mod.available():
        index = hnsw_mod.Hnsw(dim=sigs.shape[1], capacity=sigs.shape[0],
                              max_nb_connection=args.max_nb_connection,
                              ef_construction=args.ef)
        index.parallel_insert(sigs)
        index.file_dump(args.dumpfname + "-ann.hnsw")
        ids, dist = index.search(sigs, k=k + 1 + extra,
                                 ef_search=max(64, 2 * (k + extra)))
        sim = 1.0 - dist
    else:
        nn, sim0 = brute_force_neighbors(sigs, nbng=k + extra,
                                         exclude_self=True)
        ids, sim = nn.astype(np.int64), sim0
    # DistBlockSketched: same-read blocks are at distance 1.0 — drop them
    # (vectorized: pack kept hits left with one stable argsort per row)
    nq = ids.shape[0]
    ids = ids.astype(np.int64)
    keep = (ids >= 0) & (read_of[np.clip(ids, 0, None)]
                         != read_of[:, None])
    order = np.argsort(~keep, axis=1, kind="stable")
    ids2 = np.take_along_axis(ids, order, axis=1)
    sim2 = np.take_along_axis(sim, order, axis=1)
    col = np.arange(ids2.shape[1])[None, :]
    valid = col < np.minimum(keep.sum(axis=1), k)[:, None]
    out_nn = np.where(valid, ids2, 0)[:, :k].astype(np.int32)
    out_sim = np.where(valid, sim2, -1.0)[:, :k].astype(np.float32)
    write_neighbor_dump(args.dumpfname + "-ann", out_nn, out_sim)
    who.tofile(args.dumpfname + "-ann.blocks")
    print(f"block ann: {nq} blocks, {k} cross-read neighbors/block -> "
          f"{args.dumpfname}-ann")


def main(argv=None):
    import kmerutils_tpu  # noqa: F401
    from ..io import fastx, formats
    from ..sketch.jaccard import Sketcher
    from ..sketch.params import SeqSketcherParams, SketchAlgo, DataType, \
        PARAMS_DUMP_FILENAME
    from ..sketch import block as blockmod

    args = build_parser().parse_args(argv)
    t0 = time.time()
    params = SeqSketcherParams(kmer_size=args.kmer_size,
                               sketch_size=args.sketch_size,
                               algo=SketchAlgo(args.algo),
                               data_t=DataType.DNA)
    params.dump_json(os.path.join(os.path.dirname(args.dumpfname) or ".",
                                  PARAMS_DUMP_FILENAME))
    st = fastx.IngestStats()
    pack = 5000 if args.block_size else 10000

    if args.block_size:
        per_seq = []
        for batch, idx in fastx.read_batches_overlapped(
                args.filename, batch_reads=pack, stats=st, bucket=False,
                to_device=True):
            res = blockmod.block_sketch(batch, args.kmer_size,
                                        args.sketch_size, args.block_size)
            per_seq.extend(blockmod.flatten_for_dump(res, idx))
        per_seq.sort(key=lambda t: t[0])
        formats.write_block_signature_dump(args.dumpfname, args.kmer_size,
                                           args.block_size, per_seq)
        print(f"dumped block signatures for {len(per_seq)} reads")
        if args.cmd == "ann":
            _block_ann(args, per_seq)
        return 0

    sk = Sketcher(params=params)
    # block-accumulate (no per-read python loop: batches are length-bucketed
    # so row -> read mapping is restored by ONE argsort at the end).
    # Signatures materialize to host with a ONE-batch lag: the fetch both
    # bounds the async dispatch depth and keeps only one signature buffer
    # in device memory.
    blocks: list = []
    block_idx: list = []
    prev = None
    for batch, idx in fastx.read_batches_overlapped(
            args.filename, batch_reads=pack, stats=st, to_device=True):
        cur = (sk.sketch_batch(batch), np.asarray(idx))
        # queue the device->host signature copy NOW (it runs as soon as
        # the sketch completes, riding under the next batch's upload);
        # the lagged np.asarray below then just drains a finished buffer
        cur[0].copy_to_host_async()
        if prev is not None:
            blocks.append(np.asarray(prev[0])[: len(prev[1])])
            block_idx.append(prev[1])
        prev = cur
    if prev is not None:
        blocks.append(np.asarray(prev[0])[: len(prev[1])])
        block_idx.append(prev[1])
    all_idx = np.concatenate(block_idx)
    ordered = np.concatenate(blocks)[np.argsort(all_idx, kind="stable")]
    n_sketched = len(all_idx)
    sig_u32 = ordered.astype(np.uint32) if params.algo in (
        SketchAlgo.PROB3A, SketchAlgo.SUPER2) else ordered
    formats.write_signature_dump(
        args.dumpfname, args.kmer_size,
        sig_u32 if sig_u32.dtype == np.uint32 else ordered.astype(np.uint64))
    print(f"sketched {n_sketched} reads in {time.time()-t0:.1f}s")

    if args.cmd == "ann":
        from ..ann import brute_force_neighbors, write_neighbor_dump
        from .. import hnsw as hnsw_mod
        if args.engine == "hnsw" and hnsw_mod.available():
            # hnsw_rs role: insert signatures, dump the graph file
            # (datasketcher.rs:263-270,336-347), then emit the neighbor
            # table from the index
            index = hnsw_mod.Hnsw(dim=ordered.shape[1],
                                  capacity=ordered.shape[0],
                                  max_nb_connection=args.max_nb_connection,
                                  ef_construction=args.ef)
            index.parallel_insert(ordered.astype(np.uint32))
            index.file_dump(args.dumpfname + "-ann.hnsw")
            # clamp k like brute_force_neighbors: at most n-1 cross hits
            k = min(args.nbng, ordered.shape[0] - 1)
            ids, dist = index.search(ordered.astype(np.uint32),
                                     k=k + 1,
                                     ef_search=max(64, 2 * args.nbng))
            # drop the self-match by ID (an exact-duplicate read can rank
            # above self at distance 0, so position 0 is not always self)
            # AND the -1/dist-0 padding the search emits when the graph
            # returns fewer than k hits — written raw it would become
            # neighbor 0xFFFFFFFF with similarity 1.0
            nq = ids.shape[0]
            keep = (ids >= 0) & (ids != np.arange(nq, dtype=np.int64)[:, None])
            order = np.argsort(~keep, axis=1, kind="stable")
            ids2 = np.take_along_axis(ids, order, axis=1)
            sim2 = np.take_along_axis(1.0 - dist, order, axis=1)
            col = np.arange(ids2.shape[1])[None, :]
            valid = col < np.minimum(keep.sum(axis=1), k)[:, None]
            nn = np.where(valid, ids2, 0)[:, :k].astype(np.int32)
            sim = np.where(valid, sim2, -1.0)[:, :k].astype(np.float32)
            write_neighbor_dump(args.dumpfname + "-ann", nn, sim)
            print(f"hnsw graph -> {args.dumpfname}-ann.hnsw; "
                  f"{k} neighbors/read -> {args.dumpfname}-ann")
        else:
            nn, dist = brute_force_neighbors(ordered, args.nbng)
            write_neighbor_dump(args.dumpfname + "-ann", nn, dist)
            print(f"wrote {args.nbng} neighbors/read to {args.dumpfname}-ann")
    return 0


if __name__ == "__main__":
    sys.exit(main())
