"""kmerutils_tpu — a k-mer engine on an accelerator, through JAX.

A from-scratch re-design of the capabilities of the Rust crate
``jean-pierreBoth/kmerutils`` (reference mounted at /root/reference) as
batched-tensor computation on a device via JAX/XLA.

Design stance (see SURVEY.md §7):
  * reads are device-resident, 2-bit packed into uint32 words (16 bases/word),
  * k-mer extraction / canonicalization / hashing are closed-form vectorized
    kernels (no per-kmer objects, no rolling recurrences — prefix-XOR scans),
  * counting is sort/merge based (exact) with Bloom-tensor variants for
    memory-bounded streaming,
  * sketching (ProbMinHash / SuperMinHash / OptDens / SetSketch-HLL) is dense
    (item × slot) elementwise work with segmented reductions,
  * multi-device scale-out uses jax.sharding.Mesh + shard_map collectives
    (psum / all-to-all) instead of the reference's crossbeam channels.

64-bit integer support is required (u64 kmers, ntHash values); we enable
jax_enable_x64 at import time, before any JAX computation is traced.
"""

import logging
import os

import jax

jax.config.update("jax_enable_x64", True)

# RUST_LOG twin (reference lib.rs:41-54 lazy env_logger init): set
# KMERUTILS_LOG=debug|info|... to enable the package logger.
_level = os.environ.get("KMERUTILS_LOG")
if _level:
    logging.basicConfig()
    logging.getLogger(__name__).setLevel(_level.upper())

# persistent XLA compilation cache: the streaming-count graphs take seconds
# to compile at multi-10M-element shapes but milliseconds to reload, and a
# file's batch shapes recur across runs.  JAX_COMPILATION_CACHE_DIR, when
# set, is honoured as it stands (JAX reads it itself); otherwise the cache
# lives in the checkout's own .jax_cache/, a fixed path, so every process of
# one checkout shares it.  Every program is cached, however quick its
# compile, so a repeated run compiles nothing.  Opt out with
# KMERUTILS_NO_COMPCACHE=1.
CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")
if os.environ.get("KMERUTILS_NO_COMPCACHE") != "1":
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    except OSError:  # cache is an optimization, never a requirement
        pass

__version__ = "0.1.0"

from . import ops  # noqa: E402,F401
from . import base  # noqa: E402,F401
