"""Helpers for the port's tests that run on several processes: gloo ranks
of the port, one process a rank, and the JAX package on forced host
devices in a process of its own.

``run_ranks(tmp_path, world, script, spec)`` runs ``script`` (Python
source) in ``world`` processes; each reads ``RANK``, ``WORLD``, ``PORT``,
``SPEC`` (the JSON-decoded ``spec``) and ``OUT`` (its ``.npz`` path) from
the globals that :data:`PRELUDE` sets, joins a gloo process group of
``world`` ranks, and saves what it computed with ``np.savez(OUT, ...)``.
Each process has its own timeout. Returns each rank's arrays.

``run_jax(tmp_path, devices, script, spec)`` runs ``script`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=<devices>`` set before
JAX starts (as ``tests/test_moe_a2a_subprocess.py`` does), with ``SPEC``
and ``OUT`` set the same way, and returns its arrays.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

PRELUDE = r"""
import json, sys
import numpy as np
RANK, WORLD, PORT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
SPEC, OUT = json.loads(sys.argv[4]), sys.argv[5]
"""

GLOO = r"""
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                        rank=RANK, world_size=WORLD)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def run_ranks(tmp_path, world: int, script: str, spec: dict,
              timeout: float = 240) -> list[dict]:
    tmp_path.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    source = PRELUDE + GLOO + script + "\ndist.destroy_process_group()\n"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", source, str(rank), str(world), str(port),
             json.dumps(spec), str(tmp_path / f"rank{rank}.npz")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(world)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def run_jax(tmp_path, devices: int, script: str, spec: dict,
            timeout: float = 300) -> dict:
    out = tmp_path / "jax.npz"
    source = PRELUDE + script
    proc = subprocess.run(
        [sys.executable, "-c", source, "0", "1", "0", json.dumps(spec),
         str(out)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))
