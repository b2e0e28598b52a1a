"""FASTA / FASTQ ingest: host-side parsing into packed device batches.

Capability twin of parse_with_needletail (/root/reference/src/io.rs:12-72):
reads FASTA or FASTQ (plain or gzip), DROPS whole reads containing any
non-ACGT base (io.rs:41-48), 2-bit packs the survivors, and reports the same
ingest statistics (n_bases, nb_bad_bases, nb_bad_read).

The batching layer shapes the stream for the device: reads are grouped into
fixed-capacity [n_reads x max_len] batches (padding masked by lengths), with
optional length-bucketing so one giant ONT read does not blow up the padding
of a batch of short reads.  A native C++ parser (io/native) accelerates the
byte scanning; this module falls back to pure numpy when the shared library
is unavailable.
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import os

import numpy as np

from ..base import alphabet
from ..base.sequence import ReadBatch, pack_codes


@dataclasses.dataclass
class IngestStats:
    """io.rs:31-34,66-70 counters."""
    n_reads: int = 0
    n_bases: int = 0
    nb_bad_bases: int = 0
    nb_bad_read: int = 0


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)
    return f


def iter_fastx(path: str):
    """Yield (id bytes, seq bytes, qual bytes|None) records.

    Handles FASTQ — including legal WRAPPED records, where sequence and
    quality each span multiple lines (sequence ends at the '+' separator;
    quality ends once its length reaches the sequence length) — and FASTA
    (multi-line sequences).
    """
    with _open(path) as f:
        line = f.readline()
        if not line:
            return
        if line.startswith(b"@"):  # FASTQ
            while line:
                rid = line.rstrip()[1:]
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    seq_parts.append(line.rstrip())
                    line = f.readline()
                seq = b"".join(seq_parts)
                qual_parts: list[bytes] = []
                qlen = 0
                # a zero-length read still carries ONE (empty) quality line —
                # skipping it would desynchronize every later record
                first_q = True
                while qlen < len(seq) or first_q:
                    line = f.readline()
                    if not line:
                        break
                    first_q = False
                    part = line.rstrip()
                    qual_parts.append(part)
                    qlen += len(part)
                yield rid, seq, b"".join(qual_parts)
                line = f.readline()
        elif line.startswith(b">"):  # FASTA
            rid = line.rstrip()[1:]
            chunks = []
            for line in f:
                if line.startswith(b">"):
                    yield rid, b"".join(chunks), None
                    rid = line.rstrip()[1:]
                    chunks = []
                else:
                    chunks.append(line.rstrip())
            yield rid, b"".join(chunks), None
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (first byte {line[:1]!r})")


def iter_clean_reads(path: str, stats: IngestStats | None = None,
                     with_quality: bool = False):
    """Yield 2-bit code arrays for reads that are pure ACGT, dropping the
    rest — the reference's ingest policy (io.rs:41-48).

    Uses the native C++ parser (native/fastx.cpp) when built; quality
    streaming falls back to the python parser.
    """
    if not with_quality:
        from . import native
        if native.available():
            reader = native.NativeFastxReader(path)
            for codes, offsets in reader:
                for i in range(len(offsets) - 1):
                    yield codes[offsets[i] : offsets[i + 1]]
            if stats is not None:
                stats.n_bases += int(reader.stats[0])
                stats.nb_bad_bases += int(reader.stats[1])
                stats.nb_bad_read += int(reader.stats[2])
                stats.n_reads += int(reader.stats[3] - reader.stats[2])
            return
    for _rid, seq, qual in iter_fastx(path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        codes = alphabet.ENCODE_2B[raw]
        bad = int((codes == 0xFF).sum())
        if stats is not None:
            stats.n_bases += raw.size
            stats.nb_bad_bases += bad
        if bad:
            if stats is not None:
                stats.nb_bad_read += 1
            continue
        if stats is not None:
            stats.n_reads += 1
        if with_quality:
            yield codes, (np.frombuffer(qual, dtype=np.uint8) if qual else None)
        else:
            yield codes


def read_batches(path: str, batch_reads: int = 10000,
                 max_len: int | None = None,
                 stats: IngestStats | None = None,
                 bucket: bool = True,
                 quantize: bool = True,
                 packed: bool = True,
                 to_host: bool = False):
    """Yield (ReadBatch, read_indices) of at most ``batch_reads`` reads each.

    max_len: clip/segment longer reads is NOT done here — a longer read forces
    a larger batch width.  With ``bucket=True`` reads inside a parse window
    are sorted by length before batching (greedy padding reduction, the role
    of groups.rs:9-67); ``read_indices`` maps batch rows to original read
    numbers.

    ``quantize=True`` pads the batch width up to the next rung of the
    {2^i, 1.5 * 2^i} ladder (>=256 bases) and the read count up to the
    batch's row quota (zero-length padding rows carry no valid positions and
    no index entries), so batch SHAPES recur across a file and across files
    — every distinct shape costs a full XLA compile, which dominates wall
    time otherwise.  The 1.5x rungs halve the worst-case width padding
    (pure pow2 pads up to 2x, and host->device bytes and device work ride
    the padded width) at the cost of one extra shape family per octave.

    ``max_batch_bases`` caps the PADDED base capacity (rows x width) of one
    batch, so ultra-long reads (ONT 100kb+) automatically get fewer rows per
    batch instead of exploding host/device memory.

    ``packed=True`` (default) consumes the native parser's packed-word
    output when available: the C++ side emits device-layout 16-bases-per-u32
    words across threads, so batch assembly is a row copy of words instead
    of a byte-code matrix plus a python repack (~4x less host memcpy, no
    numpy packing pass).  Batches are identical either way.

    ``to_host=True`` yields ReadBatch pytrees of HOST numpy arrays instead
    of device arrays: no transfer happens at all.  This is what
    read_batches_overlapped's upload stage wants (the transfer then lives
    ONLY in its dedicated device_put thread, truly overlapping parse with
    upload) and what shape-discovery passes want (free).

    Flushing is BASE-budgeted with partial-group carry-over (round 5): the
    parse window flushes every ~4 batches of accumulated bases, emitting
    only FULL batches (row quota reached, or capacity/row-cap stopped) and
    carrying sub-quota remainders into the next window.  The old 40k-read
    window made the first batch wait for ~240 Mbases of parsing (measured
    0.92 s of pipeline-fill bubble in front of read_batches_overlapped's
    upload stage on the 384-Mbase uniform fixture) while carrying no
    benefit beyond bucketing granularity; the carry-over keeps batch
    SHAPES and row padding identical to the large-window behavior (a
    partial group is only padded to its row quota once, at end of
    stream).
    """
    import jax.numpy as jnp

    def qwidth(L):
        """Next {2^i, 1.5*2^i} rung >= max(L, 256)."""
        L = max(L, 256)
        p = 1 << (L - 1).bit_length()          # next pow2
        return 3 * p // 4 if L <= 3 * p // 4 else p

    # Fixed padded-capacity cap, NOT scaled by batch_reads: one batch is at
    # most ~8M padded bases (1024 rows at width 8192, 8192 rows at width
    # 1024, ...), which bounds the flat sort of count/stream.batch_entries
    # and the batch's device memory.  batch_reads remains the row cap for
    # short-read files.
    max_batch_bases = 8 << 20
    # window entries: (payload, length) — payload is a per-read 2-bit code
    # array (byte path) or a per-read packed-u32 word slice (packed path)
    window: list = []
    indices: list[int] = []
    next_index = 0
    from . import native
    use_packed = bool(packed) and native.available() and \
        hasattr(native._load(), "ktp_next_block_packed")

    def flush(final: bool):
        nonlocal window, indices, window_bases, window_new
        if not window:
            return
        lens = np.array([ln for _, ln in window], dtype=np.int64)
        order = np.argsort(lens, kind="stable") if bucket \
            else np.arange(len(window))
        keep: list = []
        keep_idx: list[int] = []

        def quota_rows(Lq):
            """Pow2 row quota at width Lq — the take cap AND the emitted
            row count, so every full batch at a rung has EXACTLY one
            shape (data-dependent group sizes must not leak into shapes:
            each distinct shape is a full XLA compile)."""
            q = max(1, min(batch_reads, max_batch_bases // Lq))
            n = 1 << (q - 1).bit_length()
            return n if n <= q else n >> 1

        start = 0
        while start < len(window):
            # rows allowed at this group's width (bucketed: widths ascend).
            # A group is FULL only when it stopped on the row quota or the
            # capacity cap; stopping on window exhaustion or on a rung
            # boundary (bucketed: a longer read would widen every row's
            # padding — the ascending order bounds boundary leftovers to
            # at most one sub-quota group per rung per flush) leaves a
            # sub-quota group that is carried into the next window
            # instead of shipping a mostly-padding batch.
            L0 = int(lens[order[start]])
            take = 1
            full = False
            while start + take < len(window):
                Lc = max(L0, int(lens[order[start + take]]))
                if bucket and quantize and qwidth(Lc) != qwidth(L0):
                    break                      # rung boundary: not full
                Lq = qwidth(Lc) if quantize else Lc
                cap_rows = quota_rows(Lq) if quantize else batch_reads
                if take + 1 > cap_rows or (take + 1) * Lq > max_batch_bases:
                    full = True
                    break
                take += 1
                L0 = Lc
            Lq0 = qwidth(L0) if quantize else L0
            cap_rows0 = quota_rows(Lq0) if quantize else batch_reads
            full = full or take >= cap_rows0 \
                or (take + 1) * Lq0 > max_batch_bases
            sel = order[start : start + take]
            if not final and not full:
                for i in sel:
                    keep.append(window[i])
                    keep_idx.append(indices[i])
                start += take
                continue
            group = [window[i] for i in sel]
            L = max(ln for _, ln in group)
            n = len(group)
            if quantize:
                L = qwidth(L)
                # row quota for this width, a power of two for shape reuse
                quota = max(1, min(batch_reads, max_batch_bases // L))
                n = 1 << (quota - 1).bit_length()
                if n > quota:
                    n >>= 1
                n = max(n, len(group))
            lengths = np.zeros(n, dtype=np.int32)
            if use_packed:
                n_words = -(-L // 16) + 1  # +1 slack word (ReadBatch layout)
                words = np.zeros((n, n_words), dtype=np.uint32)
                for i, (w, ln) in enumerate(group):
                    words[i, : w.size] = w
                    lengths[i] = ln
                batch = ReadBatch(
                    words=words if to_host else jnp.asarray(words),
                    lengths=lengths if to_host else jnp.asarray(lengths))
            else:
                codes = np.zeros((n, L), dtype=np.uint8)
                for i, (c, ln) in enumerate(group):
                    codes[i, :ln] = c
                    lengths[i] = ln
                batch = pack_codes(codes, lengths, as_numpy=to_host)
            yield batch, np.array([indices[i] for i in sel])
            start += take
        window, indices = keep, keep_idx
        # reset the NEW-appends triggers: carried entries must not count
        # toward the next flush or a window whose carry-over alone exceeds
        # a budget would re-scan (argsort + group walk) on EVERY appended
        # read — measured 214 s of quadratic host stall on the ONT
        # fixture (rung leftovers can carry several quota-1 groups)
        window_bases = 0
        window_new = 0

    # flush every ~4 batches of NEWLY APPENDED bases (carry-over keeps
    # sub-quota groups out of the emitted stream, so smaller windows cost
    # no extra padding); the read-count cap bounds the per-flush argsort
    # for tiny-read files
    window_budget = 4 * max_batch_bases
    window_bases = 0
    window_new = 0
    window_cap = batch_reads * 4
    if use_packed:
        reader = native.NativeFastxReader(path)
        for words, woff, lens_blk in reader.packed_blocks():
            for i in range(lens_blk.size):
                ln = int(lens_blk[i])
                window.append((words[woff[i] : woff[i + 1]], ln))
                indices.append(next_index)
                next_index += 1
                window_bases += ln
                window_new += 1
                if window_bases >= window_budget or window_new >= window_cap:
                    yield from flush(final=False)
        yield from flush(final=True)
        if stats is not None:
            stats.n_bases += int(reader.stats[0])
            stats.nb_bad_bases += int(reader.stats[1])
            stats.nb_bad_read += int(reader.stats[2])
            stats.n_reads += int(reader.stats[3] - reader.stats[2])
        return

    for codes in iter_clean_reads(path, stats):
        window.append((codes, codes.size))
        indices.append(next_index)
        next_index += 1
        window_bases += codes.size
        window_new += 1
        if window_bases >= window_budget or window_new >= window_cap:
            yield from flush(final=False)
    yield from flush(final=True)


def read_batches_overlapped(path: str, queue_depth: int = 3,
                            to_device: bool = False,
                            upload_group: int = 8, **kw):
    """read_batches through a bounded producer thread, so host parsing and
    batch assembly overlap with device compute (the role of the reference's
    producer->consumer channel pipeline, kmercount.rs:881-974: one
    generator thread feeding bounded channels).

    The native parser and gzip decompression release the GIL during C
    calls, so the producer genuinely runs while jax dispatches.  A stats=
    kwarg is filled by the producer BEFORE the stream ends, so reading it
    after exhaustion is safe.

    to_device=True additionally `jax.device_put`s each batch in a SECOND
    pipeline stage (its own thread), so the host->device transfer starts
    as soon as a batch is assembled instead of when the consumer's next
    jit call needs it, and parsing never waits on a transfer.  To that end
    the parse stage runs read_batches(to_host=True): it assembles
    pure-numpy batches and the device transfer happens ONLY in the upload
    thread.  queue_depth bounds each stage's queue (and so in-flight
    device batch buffers).

    The upload stage COALESCES up to ``upload_group`` queued batches into
    ONE `jax.device_put` pytree call (never waiting for a group to fill —
    it drains whatever the parse stage has ready).  Whether grouping still
    pays over PCIe is not measured yet.
    """
    import queue as _queue
    import threading

    depth = max(queue_depth, upload_group if to_device else 0)
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    _END = object()

    def parse_worker(out_q):
        try:
            for item in read_batches(path, **kw):
                out_q.put(item)
            out_q.put(_END)
        except BaseException as e:  # surface parse errors in the consumer
            out_q.put(e)

    if to_device:
        import jax
        kw.setdefault("to_host", True)  # parse stage stays device-free
        q0: _queue.Queue = _queue.Queue(maxsize=depth)

        def upload_worker():
            try:
                done = None
                while done is None:
                    buf = [q0.get()]
                    # opportunistic drain: group whatever parse has ready
                    while (len(buf) < upload_group
                           and not isinstance(buf[-1], BaseException)
                           and buf[-1] is not _END):
                        try:
                            buf.append(q0.get_nowait())
                        except _queue.Empty:
                            break
                    if buf[-1] is _END or isinstance(buf[-1], BaseException):
                        done = buf.pop()
                    if buf:
                        put = jax.device_put([it[0] for it in buf])
                        for d, it in zip(put, buf):
                            q.put((d,) + tuple(it[1:]))
                if done is not None:
                    q.put(done)
            except BaseException as e:
                q.put(e)

        threading.Thread(target=parse_worker, args=(q0,),
                         daemon=True).start()
        threading.Thread(target=upload_worker, daemon=True).start()
    else:
        threading.Thread(target=parse_worker, args=(q,),
                         daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def load_all(path: str, stats: IngestStats | None = None):
    """Load a whole (small) file into one ReadBatch — test convenience."""
    reads = list(iter_clean_reads(path, stats))
    if not reads:
        raise ValueError(f"no clean reads in {path}")
    L = max(c.size for c in reads)
    codes = np.zeros((len(reads), L), dtype=np.uint8)
    lengths = np.zeros(len(reads), dtype=np.int32)
    for i, c in enumerate(reads):
        codes[i, : c.size] = c
        lengths[i] = c.size
    return pack_codes(codes, lengths)


def write_fastq(path: str, reads, quals=None) -> None:
    """Write ASCII reads to a FASTQ file (test fixture generation)."""
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode()
            q = quals[i] if quals is not None else "I" * len(r)
            f.write(f"@read{i}\n{r}\n+\n{q}\n")


def write_fasta(path: str, reads) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            if isinstance(r, bytes):
                r = r.decode()
            f.write(f">read{i}\n{r}\n")
