"""Read statistics: length distribution + per-percent base composition.

Capability twin of /root/reference/src/statutils.rs (ReadBaseDistribution):

* a read-length histogram (the reference uses hdrhistogram with precision
  1..5; here exact int64 bincounts — a strict upgrade with the same dump),
* the 101 x 4 matrix: row = percentage 0..100, column = A/C/G/T, cell = the
  number (normalized to fraction) of reads whose base b occupies round(100 *
  count_b / len) percent of the read (statutils.rs:241-251),
* ascii dumps "bases.histo" (101 lines of 4 values, statutils.rs:84-113) and
  "readlen.histo" (quantile points, :118-190) consumed by the Julia
  companion.

Computation is batched on device: base counts via one segmented one-hot sum
per batch; merging across batches is plain addition (the rayon reduction of
get_base_count_par, :276-347).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from .base.sequence import ReadBatch
from .base import alphabet


# device-resident accumulator bins: reads at or beyond _HISTO_DEV bases
# clamp into the top length bin (the reference's hdrhistogram is itself
# precision-limited up there, statutils.rs:44-49); reads above upper_histo
# additionally count into histo_out, per the reference contract
_HISTO_DEV = 1 << 20


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("upper_histo",))
def _accum_batch(state, words, lengths, *, upper_histo: int):
    """Fold one batch into the device accumulator — NO host traffic.
    state = (acgt[101,4] i64, len_histo[_HISTO_DEV] i32, histo_out i64,
    n_reads i64)."""
    acgt, histo, histo_out, n_reads = state
    batch = ReadBatch(words=words, lengths=lengths)
    counts = alphabet.base_counts(batch.codes(), batch.valid_mask())
    real = lengths > 0            # zero-length rows are batch padding
    # per-percent occupancy; one-hot reduction (n x 101 x 4 compares — no
    # scatter on this path)
    pct = jnp.rint(100.0 * counts / jnp.maximum(lengths, 1)[:, None])
    pct = jnp.clip(pct, 0, 100).astype(jnp.int32)
    onehot = (pct[:, None, :] == jnp.arange(101, dtype=jnp.int32)
              [None, :, None]) & real[:, None, None]
    acgt = acgt + onehot.sum(axis=0, dtype=jnp.int64)
    # length histogram: tiny scatter (one update per read)
    over = lengths > upper_histo
    keep = real & ~over
    bins = jnp.clip(lengths, 0, _HISTO_DEV - 1)
    bins = jnp.where(keep, bins, 0)
    histo = histo.at[bins].add(keep.astype(jnp.int32), mode="drop")
    return (acgt, histo,
            histo_out + over.sum(dtype=jnp.int64),
            n_reads + real.sum(dtype=jnp.int64))


@dataclasses.dataclass
class ReadBaseDistribution:
    acgt_distribution: np.ndarray  # [101, 4] float64 (counts until normalize)
    read_lengths: np.ndarray       # growing int64 histogram over lengths
    upper_histo: int
    histo_out: int = 0
    non_acgt: int = 0
    n_reads: int = 0
    # device-resident accumulator (see _accum_batch): record_batch costs
    # ZERO host traffic — one small fetch in finish() replaces a per-batch
    # round trip that would serialize the in-order device pipeline
    _dev: tuple | None = dataclasses.field(default=None, repr=False)

    @staticmethod
    def new(readmaxsize: int = 10_000_000) -> "ReadBaseDistribution":
        return ReadBaseDistribution(
            acgt_distribution=np.zeros((101, 4), dtype=np.float64),
            read_lengths=np.zeros(0, dtype=np.int64),
            upper_histo=readmaxsize)

    # ------------------------------------------------------------------
    def record_batch(self, batch: ReadBatch) -> None:
        if self._dev is None:
            self._dev = (jnp.zeros((101, 4), jnp.int64),
                         jnp.zeros(_HISTO_DEV, jnp.int32),
                         jnp.zeros((), jnp.int64),
                         jnp.zeros((), jnp.int64))
        self._dev = _accum_batch(self._dev, batch.words, batch.lengths,
                                 upper_histo=self.upper_histo)

    def finish(self) -> "ReadBaseDistribution":
        """Fold the device accumulator into the host fields; call after
        the last record_batch (the dumps and normalized_distribution do
        so themselves)."""
        if self._dev is None:
            return self
        acgt, histo, hout, nr = (np.asarray(x) for x in self._dev)
        self._dev = None
        self.acgt_distribution += acgt.astype(np.float64)
        nz = np.flatnonzero(histo)
        if nz.size:
            L = int(nz[-1]) + 1
            grown = np.zeros(max(L, self.read_lengths.size), np.int64)
            grown[: self.read_lengths.size] += self.read_lengths
            grown[:L] += histo[:L]
            self.read_lengths = grown
        self.histo_out += int(hout)
        self.n_reads += int(nr)
        return self

    def merge(self, other: "ReadBaseDistribution") -> None:
        self.finish()
        other.finish()
        self.acgt_distribution += other.acgt_distribution
        self.histo_out += other.histo_out
        self.non_acgt += other.non_acgt
        self.n_reads += other.n_reads
        L = max(self.read_lengths.size, other.read_lengths.size)
        grown = np.zeros(L, dtype=np.int64)
        grown[: self.read_lengths.size] += self.read_lengths
        grown[: other.read_lengths.size] += other.read_lengths
        self.read_lengths = grown

    # ------------------------------------------------------------------
    def normalized_distribution(self) -> np.ndarray:
        """Fractions-of-reads matrix (the end state after get_base_count_par's
        normalization by #reads, statutils.rs:276-347)."""
        self.finish()
        if self.n_reads == 0:
            return self.acgt_distribution.copy()
        return self.acgt_distribution / self.n_reads

    def ascii_dump_acgt_distribution(self, name: str) -> None:
        m = self.normalized_distribution()
        with open(name, "w") as f:
            for i in range(m.shape[0]):
                f.write(f"{m[i, 0]} {m[i, 1]}  {m[i, 2]}  {m[i, 3]} \n")

    def ascii_dump_readlen_distribution(self, name: str,
                                        nb_points: int = 1000) -> None:
        """Quantile-sampled (length, nb_reads) points (statutils.rs:118-190)."""
        self.finish()
        total = int(self.read_lengths.sum())
        if total == 0:
            raise ValueError("empty read-length histogram")
        nbslot = max(total // 100, 1)
        cum = np.cumsum(self.read_lengths)
        # value_at_quantile(q): smallest length whose cumulative count >= q*total
        qs = np.arange(nbslot + 1) / nbslot
        readsize = np.searchsorted(cum, qs * total, side="left")
        readsize = np.clip(readsize, 0, self.read_lengths.size - 1)
        lines = []
        first_i = 0
        current_i = 0
        for j in range(nb_points):
            threshold = (total * j) // nb_points
            while current_i < nbslot and readsize[current_i] < threshold:
                current_i += 1
            if current_i < nbslot and current_i > first_i:
                nb_in_slot = ((current_i - first_i) * total) // nbslot
                lines.append((int(readsize[current_i]), nb_in_slot))
            first_i = current_i
        with open(name, "w") as f:
            for absc, nb in lines:
                f.write(f"{absc}  {nb} \n")


def get_base_count(batches, readmaxsize: int = 10_000_000) -> ReadBaseDistribution:
    """Driver over an iterable of ReadBatch — the get_base_count_par role."""
    dist = ReadBaseDistribution.new(readmaxsize)
    for b in batches:
        dist.record_batch(b)
    return dist.finish()
