"""Run a function of the port in several gloo processes on the CPU: one
interpreter a rank, the `torch.distributed` rendezvous on a free
``localhost`` port, and each process waited for with a timeout after
which every rank is killed, so a hang fails one test and no more.  The
workers import no JAX."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv: List[str], world: int, timeout: float = 120.0,
              env: Optional[Dict[str, str]] = None) -> List[str]:
    """``python argv...`` as ranks 0..world-1 (torchrun's environment:
    ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns each rank's output.  A nonzero exit or a
    timeout raises with the outputs."""
    port = str(free_port())
    base = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="localhost",
                MASTER_PORT=port, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(world)]
    outs = [""] * world
    failed = []
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                outs[r] = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r}: timed out after {timeout} s")
                break
            if p.returncode:
                failed.append(f"rank {r}: exit {p.returncode}")
                break
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                outs[r] += p.communicate()[0] or ""
    if failed:
        raise AssertionError("; ".join(failed) + "\n" + "\n".join(
            f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(outs)))
    return outs
