"""The port's expert-parallel MoE paths on gloo ranks, against its local
path on the CPU.

Each case runs one process a rank (each with its own timeout, as
``test_torch_collective.py`` runs the fabric): every rank builds the same
``DeviceMesh`` and input and the same parameters, keeps only its rules'
shard of each (``Partitioner``: its own experts), runs ``moe_apply``
through ``EPContext(mesh)`` on those DTensors and the whole input,
differentiates ``sum(y**2) + lb`` and saves its output, aux losses and
gradients (gathered), which must be the same on every rank.
Here they are held against the local path on the same parameters:

- the gather layout (experts over ``model``, the batch over ``data``) on
  ``(data, model)`` meshes ``(1, 1)``, ``(1, 2)`` and ``(2, 2)``, and the
  all-to-all layout on ``(1, 1)``: ``y``, ``lb``, ``z`` and every gradient
  at the reference's 1e-5 (``tests/test_moe.py:24-32``). With ``data`` = 2
  each rank routes its own half of the batch, so the capacity is a half's
  (``capacity_factor`` 8 drops nothing, as the reference's a2a test sets
  it) and ``lb`` and ``z`` are the mean of the local path's over the two
  halves: the local loss the gradients are held to is that mean;
- the all-to-all layout on the reference's ``(pod, data, model) = (2, 2,
  2)`` mesh (8 ranks) with ``capacity_factor`` 8, at the reference's
  bounds (``tests/test_moe_a2a_subprocess.py:33-48``: max error below
  3e-2, the bf16 wire's; ``|lb - lb_local| < 0.25``; gradients finite and
  ``w_down``'s non-zero) and every gradient leaf within 1e-2 relative L2
  of the local path's.
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

from repro_torch.configs import get_config
from repro_torch.models.layers import init_params
from repro_torch.models.moe import EPContext, moe_apply, moe_specs

ROOT = pathlib.Path(__file__).parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
LEAVES = ("router", "w_gate", "w_up", "w_down")

RANK_SCRIPT = r"""
import dataclasses, json, math, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.models.layers import init_params
from repro_torch.models.moe import EPContext, moe_apply, moe_specs
from repro_torch.launch.partitioning import Partitioner, shard_tensor
from torch.distributed.tensor import DTensor

rank, world, port, spec, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], json.loads(sys.argv[4]),
                                sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = init_device_mesh("cpu", tuple(spec["shape"]),
                        mesh_dim_names=tuple(spec["names"]))
cfg = dataclasses.replace(
    get_config("dbrx_132b").reduce(num_experts=4, top_k=2, d_model=32,
                                   d_ff=64, vocab_size=128),
    capacity_factor=spec["capacity_factor"], moe_layout=spec["layout"])
specs = moe_specs(cfg)
part = Partitioner(mesh)
full = init_params(specs, torch.Generator().manual_seed(0), torch.float32,
                   "cpu")
# each rank holds its rules' shard of every leaf (its own experts)
params = {k: shard_tensor(v, part.sharding(v.shape, specs[k].axes))
          .requires_grad_() for k, v in full.items()}
for k, p in params.items():
    assert p.to_local().numel() * math.prod(
        n for n, pl in zip(mesh.shape, p.placements) if pl.is_shard()) \
        == full[k].numel(), k
x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8, 32))
                     .astype(np.float32)).requires_grad_()
y, aux = moe_apply(params, x, cfg, EPContext(mesh=mesh))
names = sorted(params)
grads = torch.autograd.grad((y ** 2).sum() + aux["lb"],
                            [params[k] for k in names] + [x])
grads = [g.full_tensor() if isinstance(g, DTensor) else g for g in grads]
np.savez(out, y=y.detach().numpy(), lb=aux["lb"].detach().numpy(),
         z=aux["z"].detach().numpy(),
         **{"g_" + k: g.numpy() for k, g in zip(names + ["x"], grads)})
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, shape, names, layout, capacity_factor):
    world = int(np.prod(shape))
    spec = json.dumps({"shape": shape, "names": names, "layout": layout,
                       "capacity_factor": capacity_factor})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(rank), str(world),
             str(port), spec, str(tmp_path / f"rank{rank}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(world)
    ]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, logs
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _cfg(capacity_factor):
    return dataclasses.replace(
        get_config("dbrx_132b").reduce(num_experts=4, top_k=2, d_model=32,
                                       d_ff=64, vocab_size=128),
        capacity_factor=capacity_factor)


def _local(capacity_factor, blocks):
    """The local path's y on the whole batch and its ``lb``, ``z`` as the
    mean over ``blocks`` equal batch blocks (each routed alone), with the
    gradients of ``sum(y**2) + lb`` by name (``x`` included)."""
    cfg = _cfg(capacity_factor)
    params = {k: v.requires_grad_() for k, v in init_params(
        moe_specs(cfg), torch.Generator().manual_seed(0), torch.float32,
        "cpu").items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8, 32))
                         .astype(np.float32)).requires_grad_()
    ys, lbs, zs = [], [], []
    for part in x.chunk(blocks):
        y, aux = moe_apply(params, part, cfg, EPContext())
        ys.append(y)
        lbs.append(aux["lb"])
        zs.append(aux["z"])
    y = torch.cat(ys)
    lb, z = torch.stack(lbs).mean(), torch.stack(zs).mean()
    names = sorted(params)
    grads = torch.autograd.grad((y ** 2).sum() + lb,
                                [params[k] for k in names] + [x])
    out = {"y": y.detach().numpy(), "lb": lb.detach().numpy(),
           "z": z.detach().numpy()}
    out.update({"g_" + k: g.numpy() for k, g in zip(names + ["x"], grads)})
    return out


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("layout,shape,capacity_factor", [
    ("gather", (1, 1), 1.25),
    ("gather", (1, 2), 1.25),
    ("gather", (2, 2), 8.0),
    ("a2a", (1, 1), 1.25),
])
def test_expert_parallel_equals_the_local_path(tmp_path, layout, shape,
                                               capacity_factor):
    ranks = _run_ranks(tmp_path, list(shape), ["data", "model"], layout,
                       capacity_factor)
    want = _local(capacity_factor, blocks=shape[0])
    assert set(ranks[0]) == set(want)
    for got in ranks:
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **TOL,
                                       err_msg=name)
    assert float(np.abs(want["g_router"]).sum()) > 0


def test_a2a_on_the_multipod_mesh_is_within_the_wire_bounds(tmp_path):
    ranks = _run_ranks(tmp_path, [2, 2, 2], ["pod", "data", "model"], "a2a",
                       8.0)
    local = _local(8.0, blocks=1)
    blocks = _local(8.0, blocks=4)       # one batch row a (pod, data) rank
    first = ranks[0]
    for got in ranks[1:]:                # every rank holds the same values
        for name in first:
            np.testing.assert_array_equal(got[name], first[name], name)
    err = float(np.abs(first["y"] - local["y"]).max())
    assert err < 3e-2, err               # bf16 wire quantization bound
    assert abs(float(first["lb"]) - float(local["lb"])) < 0.25
    for leaf in (*LEAVES, "x"):
        g = first["g_" + leaf]
        assert np.isfinite(g).all(), leaf
        assert _rel_l2(g, blocks["g_" + leaf]) < 1e-2, leaf
        assert _rel_l2(g, local["g_" + leaf]) < 1e-2, leaf
    assert float(np.abs(first["g_w_down"]).sum()) > 0
