"""2-process multi-host dryrun: jax.distributed over a process (DCN-role)
boundary on CPU — SURVEY.md §7 step 7's testable slice.

Spawns two worker processes (4 virtual CPU devices each) that build one
8-device global mesh, run the hash-routed all_to_all count, the signature
all-gather, AND the production streaming path (ShardedStreamCounter:
merge-fold tables + LSM staging, both key widths, coords on, >= 3 batches)
across the boundary, verifying against host oracles
(tests/multihost_worker.py)."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh(tmp_path):
    port = _free_port()
    workers = []
    env = dict(os.environ)
    # workers set their own platform/device-count vars; scrub the forced
    # single-process test config so it does not leak in
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    script = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    for pid in range(2):
        workers.append(subprocess.Popen(
            [sys.executable, script, str(pid), "2", str(port),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for w in workers:
        out, _ = w.communicate(timeout=1500)
        outs.append(out.decode(errors="replace"))
    for pid, w in enumerate(workers):
        assert w.returncode == 0, f"worker {pid} failed:\n{outs[pid]}"
        assert (tmp_path / f"ok.{pid}").exists()
