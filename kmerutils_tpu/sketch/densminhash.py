"""One-permutation MinHash with densification (OptDens / RevOptDens).

Capability twin of OptDensHashSketch / RevOptDensHashSketch
(/root/reference/src/sketching/setsketchert.rs:343-596), which wrap the
probminhash crate's OptDensMinHash / RevOptDensMinHash:

* one hash per item: bucket = h1(x) mod m, value = uniform u(x) in [0,1);
  per-bucket min over the read's items (classic OPH);
* empty buckets are densified:
  - OPTDENS (Shrivastava, pmlr-2017 "Optimal densification for fast accurate
    minwise hashing"): each empty bucket walks a random probe sequence
    j -> h(j, t) mod m, t = 1, 2, ... and copies the value of the first
    *originally filled* bucket it hits;
  - REVOPTDENS (Mai et al, pmlr-2020): the reverse walk — each filled bucket
    broadcasts its value along a probe sequence into still-empty buckets,
    min-combining on collision; robust when sketch_size > #items (the regime
    the reference calls out, setsketchert.rs:490-495).

Both are vectorized over reads with a lax.while_loop over probe rounds.
Signatures are float32 bucket minima (Sig = f32 flavor of the reference);
slot-equality is the Jaccard estimator.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.rng import splitmix64, mix2_64, uniform01_f32_from_bits

U64 = jnp.uint64
F32 = jnp.float32
INF = np.float32(np.inf)


def _oph_buckets(items, valid, m: int, seed):
    """Base one-permutation hashing: per-read bucket minima [n, m] f32
    (empty buckets = +inf).

    Computed as one fused broadcast min-reduction over positions per bucket
    (bucket==b ? val : inf) — a [n, P, m] elementwise grid XLA fuses into
    the reduction.
    """
    items = jnp.asarray(items, U64)
    s64 = jnp.asarray(seed).astype(U64)
    h = splitmix64(items ^ (s64 * U64(0x9E3779B97F4A7C15) + U64(1)))
    bucket = (h % U64(m)).astype(jnp.int32)
    val = uniform01_f32_from_bits((h >> U64(32)).astype(jnp.uint32))
    hit = (bucket[..., None] == jnp.arange(m, dtype=jnp.int32)) & valid[..., None]
    return jnp.min(jnp.where(hit, val[..., None], INF), axis=1)


@functools.partial(jax.jit, static_argnames=("m", "max_rounds"))
def optdens_signatures(items, valid, m: int, seed=0, max_rounds: int = 256):
    """OPTDENS signatures f32[n, m] (+ empty flag).  ``seed`` is traced
    (one compile across a seed sweep; values identical to the old
    static-int derivation)."""
    mins = _oph_buckets(items, valid, m, seed)
    filled0 = jnp.isfinite(mins)
    any_filled = filled0.any(axis=1)

    j = jnp.arange(m, dtype=np.uint64)[None, :]

    def cond(state):
        sig, t = state
        return (t < max_rounds) & (~jnp.isfinite(sig) & any_filled[:, None]).any()

    def body(state):
        sig, t = state
        probe = (splitmix64(j ^ (U64(t) * U64(0x9E3779B97F4A7C15))
                            ^ (jnp.asarray(seed).astype(U64) * U64(77)
                               + U64(13))) % U64(m)).astype(jnp.int32)
        # value of the probed bucket, but only if ORIGINALLY filled
        src_val = jnp.take_along_axis(
            jnp.where(filled0, sig, INF), jnp.broadcast_to(probe, sig.shape), axis=1)
        sig = jnp.where(jnp.isfinite(sig), sig, src_val)
        return sig, t + 1

    sig, _ = jax.lax.while_loop(cond, body, (mins, jnp.int32(1)))
    return sig, ~any_filled


@functools.partial(jax.jit, static_argnames=("m", "max_rounds"))
def revoptdens_signatures(items, valid, m: int, seed=0, max_rounds: int = 256):
    """REVOPTDENS signatures f32[n, m] (+ empty flag): filled buckets push
    their values into empty ones, min-combining — one scatter-min per round."""
    mins = _oph_buckets(items, valid, m, seed)
    filled0 = jnp.isfinite(mins)
    any_filled = filled0.any(axis=1)
    n = mins.shape[0]
    row = jnp.arange(n, dtype=jnp.int32)[:, None]
    j = jnp.arange(m, dtype=np.uint64)[None, :]

    def cond(state):
        sig, t = state
        return (t < max_rounds) & (~jnp.isfinite(sig) & any_filled[:, None]).any()

    def body(state):
        sig, t = state
        tgt = (splitmix64(j ^ (U64(t) * U64(0xD1B54A32D192ED03))
                          ^ (jnp.asarray(seed).astype(U64) * U64(31)
                             + U64(7))) % U64(m)).astype(jnp.int32)
        tgt2 = jnp.broadcast_to(tgt, sig.shape)
        # originally-filled buckets propose their value to target buckets
        prop = jnp.where(filled0, sig, INF)
        # target receives min proposal, but only where target is still empty
        received = jnp.full_like(sig, INF).at[row, tgt2].min(prop)
        sig = jnp.where(jnp.isfinite(sig), sig, received)
        return sig, t + 1

    sig, _ = jax.lax.while_loop(cond, body, (mins, jnp.int32(1)))
    return sig, ~any_filled


def dens_jaccard(sig_a, sig_b):
    """Slot-equality Jaccard estimator (distance = 1 - this, cf. the
    reference's densification tests asserting |dist - 0.5| < 0.1)."""
    return (jnp.asarray(sig_a) == jnp.asarray(sig_b)).mean(axis=-1)
