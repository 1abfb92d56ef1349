"""The port's collective fabric vs the JAX package's, on the CPU.

- the cold-start model and ``stripe_shards`` are copies: identical
  results on several topologies and payloads;
- ``broadcast_bundle`` on a one-rank gloo group gives what the JAX
  ``broadcast_bundle`` gives on a ``(1, 1)`` mesh, in shape and bytes;
- on two gloo ranks (two processes, each with its own timeout) every rank
  ends with ``np.stack(stripe_shards(payload, 2))`` and the same checksum;
- a missing group, or a group whose backend does not serve the device,
  raises instead of picking another backend or device.

Every comparison is exact.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import ClusterTopology as JaxClusterTopology
from repro.core import broadcast_bundle as jax_broadcast_bundle
from repro.core import bundle_to_bytes as jax_bundle_to_bytes
from repro.core import coldstart_time as jax_coldstart_time
from repro.core import stripe_shards as jax_stripe_shards
from repro.kernels.checksum import device_checksum as jax_device_checksum
from repro.launch.mesh import make_test_mesh
from repro_torch.core import (
    ClusterTopology,
    allgather_bundle,
    broadcast_bundle,
    bundle_to_bytes,
    coldstart_time,
    local_stripe,
    single_rank_group,
    stripe_shards,
)

ROOT = pathlib.Path(__file__).parent.parent


def _payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


@pytest.fixture
def gloo_group():
    group = single_rank_group("cpu")
    yield group
    dist.destroy_process_group()


@pytest.mark.parametrize("n_bytes,n", [(2560, 4), (5000, 3), (1, 8), (0, 2),
                                       (4096, 1)])
def test_stripe_shards_identical(n_bytes, n):
    payload = _payload(n_bytes)
    got, want = stripe_shards(payload, n), jax_stripe_shards(payload, n)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("topo", [
    dict(num_pods=2, hosts_per_pod=256),
    dict(num_pods=1, hosts_per_pod=8),
    dict(num_pods=4, hosts_per_pod=64, cross_pod_penalty=2.0),
    dict(num_pods=8, hosts_per_pod=16, origin_up_bps=1e9),
])
@pytest.mark.parametrize("strategy", ["origin_only", "swarm", "collective"])
def test_coldstart_time_identical(topo, strategy):
    for size in (160.68e9, 1e12, 4e9):
        got = coldstart_time(ClusterTopology(**topo), size, strategy)
        want = jax_coldstart_time(JaxClusterTopology(**topo), size, strategy)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_broadcast_bundle_matches_jax_single_device(gloo_group):
    payload = _payload(5000)
    replicated, length = broadcast_bundle(payload, device="cpu")
    mesh = make_test_mesh((1, 1), ("data", "model"))
    want, want_len = jax_broadcast_bundle(payload, mesh, "data")
    assert length == want_len == len(payload)
    assert replicated.dtype == torch.uint8
    assert tuple(replicated.shape) == tuple(want.shape)
    np.testing.assert_array_equal(replicated.numpy(), np.asarray(want))
    assert bundle_to_bytes(replicated, length) \
        == jax_bundle_to_bytes(want, want_len) == payload


def test_local_stripe_and_gather_take_numpy_payloads(gloo_group):
    payload = np.frombuffer(_payload(777), np.uint8)
    stripe = local_stripe(payload, gloo_group, "cpu")
    assert tuple(stripe.shape) == (1, 777)
    out = allgather_bundle(stripe, gloo_group)
    np.testing.assert_array_equal(out.numpy()[0], payload)
    with pytest.raises(ValueError, match="stripe_len"):
        allgather_bundle(stripe.view(-1), gloo_group)


def test_device_and_backend_mismatch_raise(gloo_group):
    payload = _payload(100)
    with pytest.raises(ValueError, match="'nccl'"):
        broadcast_bundle(payload)          # device None = CUDA
    with pytest.raises(ValueError, match="'nccl'"):
        broadcast_bundle(payload, gloo_group, device="cuda")
    assert single_rank_group("cpu") is gloo_group


def test_uninitialised_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        broadcast_bundle(_payload(100), device="cpu")


RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from repro_torch.examples.checkpoint_broadcast import collective_stage

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
payload = np.random.default_rng(0).integers(0, 256, 5001, np.uint8).tobytes()
rep = collective_stage(payload, device="cpu")
np.save(out + ".npy", rep.replicated.numpy())
json.dump({"checksums": rep.checksums.tolist(), "agree": rep.agree,
           "stripe": rep.stripe.numpy().tolist()}, open(out + ".json", "w"))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_replicate_the_stripes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(rank), str(port),
             str(tmp_path / f"rank{rank}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in (0, 1)
    ]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    payload = np.random.default_rng(0).integers(0, 256, 5001,
                                                np.uint8).tobytes()
    want = np.stack(stripe_shards(payload, 2))
    want_cs = np.asarray(jax_device_checksum(want)).tolist()
    for rank in (0, 1):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"rank{rank}.npy"), want)
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert got["agree"] is True
        assert got["checksums"] == [want_cs, want_cs]
        assert got["stripe"] == [want[rank].tolist()]
