"""The port's dry-run (``launch/dryrun.py``, ``launch/roofline.py``).

- Every arch at full width on the production meshes (16, 16) and (2, 16,
  16), the rules alone (nothing built): the bytes of the train state
  (parameters, both moments, the int8 residual of the compressed
  variant) and of the inputs that one rank holds in the dry-run's layout
  equal the sum of the shard sizes that the JAX ``Partitioner``'s specs
  give, exactly.
- The reference's ``tests/test_hlo_analysis.py`` cases on
  ``roofline.py`` at H100 constants: the collective bytes by kind (here
  counted from functional collectives on a one-rank gloo group), the
  roofline terms and the bottleneck, the model-FLOPs conventions.
- The reference's ``tests/test_dryrun_subprocess.py``: granite_3_2b
  ``train_4k`` on the (2, 2, 2) test mesh with ``--reduced`` is ``ok``,
  with compute time, a peak and collectives above 0; here also its
  state's bytes against the JAX specs. With it, in the same subprocess
  (the fake default group is global to its process), half of the archs
  at ``--reduced`` on the test mesh, every shape ``ok`` or the
  reference's ``applicable`` skip; ``tests/test_torch_dryrun_archs.py``
  runs the other half.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS, SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_config
from repro.jax_compat import abstract_mesh as jax_abstract_mesh
from repro.launch.partitioning import Partitioner as JaxPartitioner
from repro.models import build_model as jax_build
from repro_torch.compat import AbstractMesh
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.collective_fabric import single_rank_group
from repro_torch.launch import dryrun, roofline as rl

ROOT = Path(__file__).resolve().parent.parent
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
#: the archs this file runs at --reduced (the rest: test_torch_dryrun_archs)
ARCHS = ("granite_3_2b", "arctic_480b", "dbrx_132b", "recurrentgemma_2b",
         "seamless_m4t_medium")

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "int32": 4}


def _shard_bytes(spec, shape, itemsize, sizes) -> int:
    """One device's bytes of an array under a JAX spec (every sharded
    dim divides, as the rules guarantee)."""
    parts = 1
    for entry in spec:
        for a in (() if entry is None else (entry,) if isinstance(entry, str)
                  else entry):
            parts *= sizes[a]
    n = math.prod(shape)
    assert n % parts == 0
    return n // parts * itemsize


def jax_placed_bytes(arch, shape_name, mesh_shape, names, tcfg) -> dict:
    """``dryrun.placed_bytes`` from the reference's specs."""
    import jax

    jb = jax_build(jax_config(arch))
    part = JaxPartitioner(jax_abstract_mesh(mesh_shape, names))
    sizes = dict(zip(names, mesh_shape))
    leaves = jax.tree_util.tree_leaves(jb.abstract())
    axes = jax.tree_util.tree_leaves(
        jb.axes, is_leaf=lambda x: isinstance(x, tuple))
    pbytes = _DTYPE_BYTES[jb.cfg.param_dtype]
    sbytes = _DTYPE_BYTES[tcfg.opt_state_dtype]
    params = moments = 0
    for leaf, ax in zip(leaves, axes, strict=True):
        spec = tuple(part.spec(leaf.shape, ax))
        params += _shard_bytes(spec, leaf.shape, pbytes, sizes)
        moments += _shard_bytes(spec, leaf.shape, sbytes, sizes)
    moments *= 3 if tcfg.grad_compression != "none" else 2
    shape = JAX_SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    cfg = jb.cfg
    inputs = {"tokens": ((b, s), 4, 0), "targets": ((b, s), 4, 0)}
    if cfg.encoder_layers > 0:
        inputs["src_embeds"] = ((b, s, cfg.d_model),
                                _DTYPE_BYTES[cfg.compute_dtype], 0)
    if cfg.rope_mode == "mrope":
        inputs["positions"] = ((3, b, s), 4, 1)
    ins = 0
    for ishape, itemsize, bdim in inputs.values():
        ax = [None] * len(ishape)
        ax[bdim] = "batch"
        ins += _shard_bytes(tuple(part.spec(ishape, tuple(ax))), ishape,
                            itemsize, sizes)
    return {"params": params, "optimizer": moments, "inputs": ins}


@pytest.mark.parametrize("variant", ["", "int8_xpod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placed_bytes_match_the_reference_specs(arch, variant):
    overrides = {**dryrun.TRAIN_OVERRIDES.get(arch, {}),
                 **dryrun.VARIANTS.get(variant, {}).get("train", {})}
    tcfg = TrainConfig(**overrides)
    for mesh_shape, names in MESHES:
        got = dryrun.placed_bytes(get_config(arch), SHAPES["train_4k"],
                                  AbstractMesh(mesh_shape, names), tcfg)
        want = jax_placed_bytes(arch, "train_4k", mesh_shape, names, tcfg)
        assert got == want, (mesh_shape, got, want)


# ------------------------------------------------ tests/test_hlo_analysis.py


def test_collective_byte_count():
    """Each functional collective by the bytes of its larger buffer, as
    the reference parses its HLO's collectives by kind."""
    from torch.distributed._functional_collectives import (
        all_gather_single, all_reduce, all_to_all_single, reduce_scatter_single,
    )

    single_rank_group("cpu")
    try:
        group = dist.group.WORLD
        counter = rl.DeviceCounter()
        with counter:
            all_gather_single(torch.zeros(16, 8, dtype=torch.bfloat16), 0,
                              group).wait()
            all_reduce(torch.zeros(1024), "sum", group).wait()
            all_reduce(torch.zeros(512), "max", group).wait()
            reduce_scatter_single(torch.zeros(64, 32), "sum", 0,
                                  group).wait()
            all_to_all_single(torch.zeros(8, 128, dtype=torch.bfloat16),
                              None, None, group).wait()
            torch.zeros(9999) + 1.0                      # not a collective
    finally:
        dist.destroy_process_group()
    out = counter.collective_bytes()
    assert out["all-gather"] == 16 * 8 * 2
    assert out["all-reduce"] == (1024 + 512) * 4
    assert out["reduce-scatter"] == 64 * 32 * 4
    assert out["all-to-all"] == 8 * 128 * 2
    assert out["collective-permute"] == 0
    assert out["count"] == 5
    assert out["total"] == sum(out[k] for k in rl.KINDS)


def test_roofline_terms_and_bottleneck():
    r = rl.Roofline(flops=rl.PEAK_FLOPS, hbm_bytes=rl.HBM_BW * 2,
                    coll_bytes=rl.IB_BW * 3,
                    model_flops=rl.PEAK_FLOPS * 256 * 0.5, chips=256)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(3.0)
    assert r.bottleneck == "collective"
    assert r.t_bound == pytest.approx(3.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.mfu_bound == pytest.approx(0.5 / 3.0)
    # H100 constants, and a collective priced by its axis: NVLink within
    # a node of eight, InfiniBand across
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.HBM_BYTES) == (989e12, 3.35e12,
                                                       80e9)
    assert rl.axis_bandwidth({"pod": 2, "data": 2, "model": 2},
                             "pod") == rl.NVLINK_BW
    assert rl.axis_bandwidth({"data": 16, "model": 16}, "model") == rl.IB_BW
    assert rl.axis_bandwidth({"data": 16, "model": 16}, "data") == rl.IB_BW


def test_model_flops_conventions():
    assert rl.model_flops_for("train", 10, 8, 100) == 6 * 8 * 100
    assert rl.model_flops_for("prefill", 10, 8, 100) == 2 * 8 * 100
    assert rl.model_flops_for("decode", 10, 8, 128) == 2 * 8 * 128


# ------------------------------------------------ the CLI, reduced


def run_reduced(out: Path, archs) -> subprocess.CompletedProcess:
    """``python -m repro_torch.launch.dryrun --arch ... --mesh test
    --reduced`` in a process of its own (its fake default group)."""
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
           "--arch", *archs, "--mesh", "test", "--reduced", "--out", str(out)]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)


def check_cells(out: Path, archs) -> None:
    """Every (arch x shape) cell ``ok``, or skipped for the reference's
    reason."""
    for arch in archs:
        for name, shape in SHAPES.items():
            cell = json.loads((out / f"{arch}__{name}__test.json").read_text())
            reduced = jax_config(arch).reduce(param_dtype="bfloat16",
                                              compute_dtype="bfloat16")
            ok, reason = jax_applicable(reduced, JAX_SHAPES[name])
            if ok:
                assert cell["status"] == "ok", cell.get("error")
                assert cell["roofline"]["flops_per_device"] > 0
            else:
                assert cell["status"] == "skip"
                assert cell["reason"] == reason


@pytest.fixture(scope="module")
def reduced_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = run_reduced(out, ARCHS)
    return out, proc


def test_reduced_dryrun_multipod_mesh(reduced_run):
    out, proc = reduced_run
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cell = json.loads((out / "granite_3_2b__train_4k__test.json").read_text())
    assert cell["status"] == "ok"
    assert cell["roofline"]["t_compute_s"] > 0
    assert cell["memory"]["peak_estimate_bytes"] > 0
    assert cell["collectives"]["total"] > 0  # the pod axis actually shards
    # the state the run held is the rules' own
    shape = dict(cell["shape_config"])
    names = ("pod", "data", "model")
    want = dryrun.placed_bytes(
        get_config("granite_3_2b").reduce(param_dtype="bfloat16",
                                          compute_dtype="bfloat16"),
        SHAPES["train_4k"].__class__(**shape), AbstractMesh((2, 2, 2), names),
        TrainConfig())
    got = {k: cell["memory"][f"{k}_bytes"] for k in want}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cells_run_or_skip(reduced_run, arch):
    out, proc = reduced_run
    assert proc.returncode == 0, proc.stdout + proc.stderr
    check_cells(out, [arch])
