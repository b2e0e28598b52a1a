"""SetSketch / HyperLogLog-family sketches (Ertl, VLDB 2021) — mergeable
integer-register signatures.

Capability twin of HyperLogLogSketch (/root/reference/src/sketching/
setsketchert.rs:600-896) wrapping probminhash's SetSketcher: registers
hold truncated-geometric order statistics, the whole sketch merges by
elementwise max — the property the reference exploits to sketch a file in
parallel blocks then union (sketch_compressedkmer_seqs :811-895), and that we
exploit across a device mesh with one jax.lax.pmax.

Register definition (SetSketch1 of the paper): for item d and register i,

    value(d, i) = clamp( 1 + floor( log_b( a / E(d, i) ) ), 0, q )

with E(d, i) ~ Exp(1) drawn as a pure function of (d, i); K_i = max_d value.
P(K_i <= z) = exp(-n a b^(-z)) for n distinct items, giving the cardinality
estimator  n_hat = m (1 - 1/b) / (a ln b * sum_i b^(-K_i))  and, for two
sketches, Jaccard by inclusion-exclusion on (|A|, |B|, |A u B|) where the
union sketch is the register max.

Defaults (b=1.001, a=20, q=65534, u16 registers) match the regime the
reference uses for memory-tight huge-k sketching (README.md:40-41).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.rng import mix2_64

U64 = jnp.uint64
F32 = jnp.float32


@dataclasses.dataclass(frozen=True)
class SetSketchParams:
    """Twin of probminhash::setsketcher::SetSketchParams."""
    b: float = 1.001
    a: float = 20.0
    q: int = 65534        # fits u16 with one spare value
    m: int = 4096         # number of registers (sketch size)

    @property
    def register_dtype(self):
        if self.q <= 0xFFFE:
            return jnp.uint16
        if self.q <= 0xFFFFFFFE:
            return jnp.uint32
        return jnp.uint64


@functools.partial(jax.jit, static_argnames=("params",))
def setsketch_signatures(items, valid, params: SetSketchParams, seed=0):
    """Per-read SetSketch registers [n, m] (integer dtype per params.q).

    items uint64/uint32[n, P], valid bool[n, P].  One fused u32-hash +
    draw + max-reduction over positions (the same shape as the ProbMinHash
    tournament) — the [n, P, m] grid never reaches HBM.  ``seed`` is
    traced (one compile across a seed sweep).
    """
    items = jnp.asarray(items)
    if items.dtype == jnp.uint64:
        it32 = (items ^ (items >> U64(32))).astype(jnp.uint32)
    else:
        it32 = items.astype(jnp.uint32)
    m = params.m
    c = jnp.uint32
    salts = (mix2_64(jnp.arange(m, dtype=np.uint64),
                     jnp.asarray(seed).astype(U64) * U64(2) + U64(1))
             >> U64(32)).astype(c)
    # The register value is a monotone NON-DECREASING function of the
    # uniform draw u (e = -ln u decreases in u, log_b(a/e) increases), and
    # u is monotone in the raw u32 hash.  So max over positions of val(u)
    # = val(max over positions of h): the reduction runs on the integer
    # hash alone (~6 elementwise ops per (position, register) pair) and the
    # transcendental epilogue runs once per register on [n, m].
    h = it32[..., None] ^ salts
    h = h * c(0x9E3779B1)
    h = h ^ (h >> c(15))
    h = h * c(0x85EBCA77)                 # draw uses the top 24 bits only
    h = jnp.where(valid[..., None], h, c(0))
    h_best = jnp.max(h, axis=1)                               # [n, m]
    u = (h_best >> c(8)).astype(F32) * F32(2.0**-24) + F32(2.0**-24)
    e = -jnp.log(u)                                           # Exp(1)
    inv_ln_b = np.float32(1.0 / np.log(params.b))
    val = 1.0 + jnp.floor((np.float32(np.log(params.a)) - jnp.log(e)) * inv_ln_b)
    val = jnp.clip(val, 0.0, float(params.q))
    empty = ~valid.any(axis=1)
    regs = jnp.where(empty[:, None], 0.0, val)
    return regs.astype(params.register_dtype)


def merge(regs_a, regs_b):
    """Union of the underlying sets — elementwise max (mergeability that the
    reference's block sketcher relies on, setsketchert.rs:863-888)."""
    return jnp.maximum(regs_a, regs_b)


def cardinality(regs, params: SetSketchParams):
    """Ertl's GHLL cardinality estimator from registers [..., m]."""
    k = jnp.asarray(regs).astype(jnp.float64)
    b = float(params.b)
    s = jnp.power(b, -k).sum(axis=-1)
    m = params.m
    return m * (1.0 - 1.0 / b) / (float(params.a) * np.log(b)) / s


def jaccard(regs_a, regs_b, params: SetSketchParams):
    """Jaccard via inclusion-exclusion with the union (max-merge) sketch."""
    na = cardinality(regs_a, params)
    nb = cardinality(regs_b, params)
    nu = cardinality(merge(regs_a, regs_b), params)
    inter = jnp.maximum(na + nb - nu, 0.0)
    return jnp.where(nu > 0, inter / nu, 0.0)
