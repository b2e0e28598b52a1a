"""Time the streaming table's fold and aggregate on the device, alone.

Builds, on the device, a table of random sorted entries filled to half its
capacity plus a sorted batch run, then times ops/merge.merge_fold_i32 and
ops/merge.aggregate_fold_i32 with ``jax.block_until_ready`` around repeated
calls.  Each time is printed beside the HBM-roofline time of one read and
one write of the live table (and of the whole capacity), with the device
kind and the card's name and power limit.

Configurations (the bench's ``stream_count`` shape and the wide path):

  narrow  k=16, no coordinates, capacity 2^28; one 1024x8192 batch, and
          the four-batch run a depth-2 StagedFolder folds at that capacity
  wide    k=31 with coordinates, capacity 2^27 (the CLI's cap with
          coordinates), same runs

Run on the accelerator:
  python tools/profile_stream.py [--small] [--trace DIR]
``--small`` cuts capacities by 2^8 (a rehearsal on the CPU backend);
``--trace DIR`` records one profiler trace per op and prints the device
kernels that took the time.
"""

from __future__ import annotations

import argparse
import functools
import glob
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/tools/", 1)[0])
import kmerutils_tpu  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kmerutils_tpu.ops import merge  # noqa: E402

# device memory bandwidth, bytes/s, by jax device_kind (NVIDIA H100 SXM
# data sheet: 80 GB HBM3 at 3.35 TB/s, at the full 700 W power limit)
HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}

BATCH = 1024 * 8192
CONFIGS = {
    "narrow": dict(wide=False, coords=False, cap_log2=28),
    "wide": dict(wide=True, coords=True, cap_log2=27),
}


def card_name() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


@functools.partial(jax.jit, static_argnames=("n", "hi_bits"))
def _sorted_keys(key, n: int, hi_bits: int):
    """n ascending random keys of hi_bits bits, +1-biased, as u64."""
    k = jax.random.bits(key, (n,), jnp.uint64)
    return jnp.sort(k >> jnp.uint64(64 - hi_bits)) + jnp.uint64(1)


def _entries(key, n: int, wide: bool, coords: bool):
    """n raw sorted entries (u32 arrays, count 1 each) on the device."""
    k1, k2 = jax.random.split(key)
    keys = _sorted_keys(k1, n=n, hi_bits=62 if wide else 31)
    arrs = ((keys >> jnp.uint64(32)).astype(jnp.uint32),
            keys.astype(jnp.uint32)) if wide else (keys.astype(jnp.uint32),)
    arrs = arrs + (jnp.ones(n, jnp.uint32),)
    if coords:
        c = jax.random.bits(k2, (2, n), jnp.uint32)
        arrs = arrs + (c[0], c[1])
    return arrs


def _to_table(arrs, cap: int, ncmp: int):
    """Raw u32 entries -> the table's int32 layout of length cap."""
    out = []
    for j, x in enumerate(arrs):
        x = jnp.concatenate([x, jnp.full(cap - x.shape[0], 0xFFFFFFFF,
                                         jnp.uint32)])
        out.append(merge._flip(x) if j < ncmp
                   else jax.lax.bitcast_convert_type(x, jnp.int32))
    return tuple(out)


def timed(fn, n_iter: int) -> float:
    """Median seconds per call over n_iter synced calls (after a warm-up
    call that compiles)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_table(trace_dir: str, top: int = 8) -> list:
    """(kernel name, total device ns) of the largest device events in the
    newest trace under trace_dir."""
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    tot: dict = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if "Module" in line.name or "Step" in line.name:
                continue
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0) + ev.duration_ns
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]


def trace(fn, trace_dir: str) -> list:
    jax.block_until_ready(fn())
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(fn())
    jax.profiler.stop_trace()
    return kernel_table(trace_dir)


def profile(name: str, cfg: dict, small: bool, n_iter: int,
            trace_dir: str | None) -> dict:
    """Times of the fold (one batch, four-batch run) and the aggregate for
    one configuration."""
    fold_fn = merge.merge_fold_i32
    wide, coords = cfg["wide"], cfg["coords"]
    cap = 1 << (cfg["cap_log2"] - (8 if small else 0))
    batch = BATCH >> (8 if small else 0)
    ncmp = 2 if wide else 1
    kw = ncmp
    used = cap // 2
    key = jax.random.PRNGKey(7)
    table = _to_table(_entries(key, used, wide, coords), cap, ncmp)
    narr = len(table)
    peak = HBM_PEAK.get(jax.devices()[0].device_kind)
    live_bytes = 2 * used * narr * 4          # one read + one write
    cap_bytes = 2 * cap * narr * 4
    res = {"config": name, "capacity": cap, "used": used, "arrays": narr}
    for nb in (batch, 4 * batch):
        b = _entries(jax.random.fold_in(key, nb), nb, wide, coords)
        dt = timed(lambda: fold_fn(table, b, used, ncmp=ncmp), n_iter)
        res[f"fold_{nb}_ms"] = dt * 1e3
        if trace_dir:
            res[f"fold_{nb}_kernels"] = trace(
                lambda: fold_fn(table, b, used, ncmp=ncmp),
                f"{trace_dir}/{name}_fold_{nb}")
    dt = timed(lambda: merge.aggregate_fold_i32(table, used, kw=kw,
                                                coords=coords), n_iter)
    res["aggregate_ms"] = dt * 1e3
    if trace_dir:
        res["aggregate_kernels"] = trace(
            lambda: merge.aggregate_fold_i32(table, used, kw=kw,
                                             coords=coords),
            f"{trace_dir}/{name}_aggregate")
    if peak:
        res["roofline_live_ms"] = live_bytes / peak * 1e3
        res["roofline_capacity_ms"] = cap_bytes / peak * 1e3
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card_name()}", flush=True)
    if not args.small and dev.device_kind not in HBM_PEAK:
        print(f"no HBM peak for {dev.device_kind!r}", file=sys.stderr)
        return 1
    for name, cfg in CONFIGS.items():
        res = profile(name, cfg, args.small, args.iters, args.trace)
        for k, v in res.items():
            print(f"  {name:6s} {k:22s} {v}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
