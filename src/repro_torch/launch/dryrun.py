"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step in its
rules' layout on 256 or 512 ranks, in one process and with no device,
and give its per-device counts, memory and roofline terms at H100
constants (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 forced host devices
(``XLA_FLAGS`` set before JAX starts). Here the counterpart of those
devices is a fake default process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once), started only in this dedicated process by :func:`main`
(or :func:`fake_world`), never on import; the mesh is the real
``DeviceMesh`` of :func:`~repro_torch.launch.mesh.make_production_mesh`
(``(16, 16)`` over ``("data", "model")``, ``(2, 16, 16)`` over ``("pod",
"data", "model")``) or the ``(2, 2, 2)`` test mesh over it, this process
being rank 0. The state and the inputs are DTensors placed by the rules
(``Partitioner``), each built from its local shard's shape under
``FakeTensorMode``: nothing is allocated. Each cell then runs, once,
the functions the card runs: a train step (``make_train_step(...,
mesh=, pod_axis="pod", grad_shardings=)``), a prefill (``prefill_fn``)
or a decode step (``decode_fn``), every layer of it (eager execution has
no scan body to extrapolate from, so the reference's depth-1/depth-2
probes have no counterpart). :class:`~repro_torch.launch.roofline.
DeviceCounter` counts rank 0's FLOPs, HBM bytes, collectives and memory
on its local tensors, and :class:`~repro_torch.launch.roofline.Roofline`
prices them. Every number is a prediction of the H100 data sheet's
rates, not a measurement. The device type is the CPU's: every device
branch of the model is inside a kernel op, whose fake implementation
runs here, so the program is the card's.

Per cell we write one JSON (the reference's file names and fields):
``memory`` (arguments by category, the peak, ``fits`` 80 GB),
``collectives`` (bytes by kind, ``count``, ``total``), ``roofline``, the
parameter counts and tokens. A cell that raises is ``status: "error"``,
and the CLI exits non-zero.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k \
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both \
      --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --arch granite_3_2b \
      --shape train_4k --mesh test --reduced
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..compat import set_mesh
from ..configs import SHAPES, applicable, get_config
from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..configs.registry import ARCH_IDS
from ..models import EPContext, build_model
from ..models.layers import ParamTree
from ..models.transformer import layer_specs
from ..train import optimizer as opt
from ..train.train_step import TrainState, make_train_step
from . import roofline as rl
from .mesh import make_production_mesh, make_test_mesh
from .partitioning import Partitioner, Sharding, batch_shardings, param_shardings

# dry-run per-arch training overrides: the big MoEs need bf16 moments to fit
TRAIN_OVERRIDES = {
    "arctic_480b": dict(opt_state_dtype="bfloat16"),
    "dbrx_132b": dict(opt_state_dtype="bfloat16"),
}

# the reference's named {model:..., train:...} deltas vs baseline
VARIANTS: dict[str, dict] = {
    "a2a_moe": {"model": dict(moe_layout="a2a")},
    "int8_xpod": {"train": dict(grad_compression="int8",
                                opt_state_dtype="float32")},
    "remat_none": {"model": dict(remat="none")},
    "remat_dots": {"model": dict(remat="dots")},
    "a2a_mb4": {"model": dict(moe_layout="a2a"),
                "train": dict(microbatches=4)},
    "mb2": {"train": dict(microbatches=2)},
    "a2a_mb8": {"model": dict(moe_layout="a2a"),
                "train": dict(microbatches=8)},
    "kv_int8": {"model": dict(kv_cache_dtype="int8")},
}

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "test": ((2, 2, 2), ("pod", "data", "model")),
          "one": ((1, 1, 1), ("pod", "data", "model"))}


def fake_world(size: int) -> None:
    """Start this process's default group as rank 0 of a fake group of
    ``size`` ranks (collectives return at once), replacing one of another
    size. Only a dedicated process may do this."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def make_mesh(name: str):
    shape, axes = MESHES[name]
    fake_world(math.prod(shape))
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi", device="cpu")
    return make_test_mesh(shape, axes, device="cpu")


# --------------------------------------------------------------------------- fake shards


def local_shape(shape, sharding: Sharding) -> tuple:
    """The shape of this rank's shard (every sharded dim divides)."""
    out = list(shape)
    for size, p in zip(sharding.mesh.shape, sharding.placements):
        if p.is_shard():
            out[p.dim] //= int(size)
    return tuple(out)


def fake_dtensor(shape, dtype, sharding: Sharding) -> DTensor:
    """A DTensor of global ``shape`` placed by ``sharding``, its local
    shard an empty tensor of the current fake mode."""
    local = torch.empty(local_shape(shape, sharding), dtype=dtype)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=tuple(shape),
                              stride=stride)


def fake_params(bundle, mesh, trainable: bool):
    """The parameter module with every parameter a fake DTensor of the
    rules' placements."""
    shardings = param_shardings(bundle, mesh)
    module = bundle.skeleton(trainable)
    for name, p in list(module.named_parameters()):
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path))
        owner._parameters[leaf] = torch.nn.Parameter(
            fake_dtensor(p.shape, p.dtype, shardings[name]),
            requires_grad=trainable)
    return module, shardings


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The reference's inputs of a cell: ``{name: (shape, dtype)}``."""
    b, s = shape.global_batch, shape.seq_len
    cdtype = getattr(torch, cfg.compute_dtype)
    if shape.kind == "train":
        specs = {"tokens": ((b, s), torch.int32),
                 "targets": ((b, s), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": ((b, s), torch.int32)}
    else:
        specs = {"tokens": ((b, 1), torch.int32)}
    if cfg.encoder_layers > 0:
        enc_s = s if shape.kind != "decode" else min(s, 4096)
        specs["src_embeds"] = ((b, enc_s, cfg.d_model), cdtype)
    if cfg.rope_mode == "mrope" and shape.kind != "decode":
        specs["positions"] = ((3, b, s), torch.int32)
    return specs


def input_shardings(cfg: ModelConfig, shape: ShapeConfig,
                    part: Partitioner) -> dict:
    """Each input's sharding: batch over ('pod', 'data')."""
    metas = {k: torch.empty(sh, dtype=dt, device="meta")
             for k, (sh, dt) in input_shapes(cfg, shape).items()}
    return batch_shardings(part, metas)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, part: Partitioner
                ) -> dict:
    """The reference's inputs as fake DTensors, batch over ('pod',
    'data')."""
    shardings = input_shardings(cfg, shape, part)
    return {k: fake_dtensor(sh, dt, shardings[k])
            for k, (sh, dt) in input_shapes(cfg, shape).items()}


def placed_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 tcfg: TrainConfig) -> dict:
    """The bytes of the train state and the inputs that one rank holds in
    the rules' layout (``mesh`` a ``DeviceMesh`` or an ``AbstractMesh``:
    the rules alone, nothing built): ``{"params", "optimizer",
    "inputs"}``, as :func:`execute_cell` places them."""
    bundle = build_model(cfg, "cpu")
    part = Partitioner(mesh)
    shardings = param_shardings(bundle, mesh)
    metas = dict(ParamTree(layer_specs(cfg), getattr(torch, cfg.param_dtype),
                           "meta").named_parameters())

    def size(shape_, dtype, sharding):
        return math.prod(local_shape(shape_, sharding)) * dtype.itemsize

    params = sum(size(p.shape, p.dtype, shardings[n])
                 for n, p in metas.items())
    sdt = getattr(torch, tcfg.opt_state_dtype)
    moments = 3 if tcfg.grad_compression != "none" else 2
    optimizer = moments * sum(size(p.shape, sdt, shardings[n])
                              for n, p in metas.items())
    ins = input_shardings(cfg, shape, part)
    inputs = sum(size(sh, dt, ins[k])
                 for k, (sh, dt) in input_shapes(cfg, shape).items())
    return {"params": params, "optimizer": optimizer, "inputs": inputs}


def fake_cache(bundle, part: Partitioner, batch: int, capacity: int,
               cross_len: int = 0):
    """The decode cache as fake DTensors placed by the cache rules."""
    cache = bundle.cache_abstract(batch, capacity, cross_len)
    axes = bundle.cache_axes(batch, capacity, cross_len)

    def walk(c, a):
        if isinstance(c, dict):
            return {k: walk(c[k], a[k]) for k in c}
        if isinstance(c, list):
            return [walk(x, y) for x, y in zip(c, a)]
        return fake_dtensor(c.shape, c.dtype,
                            part.sharding(tuple(c.shape), tuple(a)))

    return walk(cache, axes)


# --------------------------------------------------------------------------- one cell


def _train_config(arch: str, overrides: dict | None) -> TrainConfig:
    return TrainConfig(**{**TRAIN_OVERRIDES.get(arch, {}),
                          **(overrides or {})})


def execute_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, arch: str,
                 train_overrides: dict | None = None) -> tuple:
    """Run the cell's step once on fake DTensors under a
    :class:`~repro_torch.launch.roofline.DeviceCounter`; returns
    ``(counter, tokens)``."""
    part = Partitioner(mesh)
    names = mesh.mesh_dim_names
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    ep = EPContext(mesh=mesh if cfg.is_moe else None, ep_axis="model",
                   dp_axes=dp_axes)
    bundle = build_model(cfg, "cpu", ep)
    counter = rl.DeviceCounter(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True), set_mesh(mesh):
        inputs = input_specs(cfg, shape, part)
        if shape.kind == "train":
            tcfg = _train_config(arch, train_overrides)
            params, shardings = fake_params(bundle, mesh, trainable=True)
            sdt = getattr(torch, tcfg.opt_state_dtype)
            leaves = dict(params.named_parameters())

            def moments():
                return {n: fake_dtensor(p.shape, sdt, shardings[n])
                        for n, p in leaves.items()}

            state = TrainState(params, opt.OptState(
                step=torch.zeros((), dtype=torch.int32), mu=moments(),
                nu=moments(),
                residual=moments() if tcfg.grad_compression != "none"
                else None))
            step_fn = make_train_step(
                bundle, tcfg, mesh=mesh, pod_axis="pod",
                grad_shardings=part.tree_shardings(bundle.abstract(),
                                                   bundle.axes))
            counter.track(leaves, "params")
            counter.track((state.opt.mu, state.opt.nu,
                           state.opt.residual), "optimizer")
            counter.track(inputs, "inputs")
            with counter:
                step_fn(state, inputs)
            tokens = shape.tokens
        else:
            params, _ = fake_params(bundle, mesh, trainable=False)
            counter.track(dict(params.named_parameters()), "params")
            if shape.kind == "prefill":
                counter.track(inputs, "inputs")
                with counter:
                    bundle.prefill_fn(params, inputs)
                tokens = shape.tokens
            else:
                b = shape.global_batch
                cross_len = min(shape.seq_len, 4096) if cfg.encoder_layers \
                    else 0
                cache = fake_cache(bundle, part, b, shape.seq_len, cross_len)
                pos_axes = ((None, "batch", None) if cfg.rope_mode == "mrope"
                            else ("batch", None))
                pos_shape = (3, b, 1) if cfg.rope_mode == "mrope" else (b, 1)
                pos = fake_dtensor(pos_shape, torch.int32,
                                   part.sharding(pos_shape, pos_axes))
                counter.track(cache, "cache")
                counter.track((inputs, pos), "inputs")
                with counter:
                    bundle.decode_fn(params, inputs["tokens"], pos, cache,
                                     shape.seq_len)
                tokens = b
    return counter, tokens


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path,
             reduced: bool = False, mesh=None, variant: str = "",
             shape_overrides: dict | None = None,
             train_overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    if variant:
        v = VARIANTS[variant]
        cfg = dataclasses.replace(cfg, **v.get("model", {}))
        train_overrides = {**v.get("train", {}), **(train_overrides or {})}
    if reduced:
        cfg = cfg.reduce(param_dtype="bfloat16", compute_dtype="bfloat16")
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_mesh(mesh_name)
    sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    if reduced:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 256),
            global_batch=max(sizes.get("pod", 1) * sizes.get("data", 1) * 2,
                             8))
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    ok, reason = applicable(cfg, shape)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "status": "skip", "reason": reason,
        "variant": variant,
    }
    if not ok:
        _write(out_dir, result)
        return result

    chips = math.prod(sizes.values())
    t0 = time.time()
    try:
        counter, tokens = execute_cell(cfg, shape, mesh, arch,
                                       train_overrides)
        coll = counter.collective_bytes()
        total, active = cfg.param_count()
        roof = rl.Roofline(
            flops=float(counter.flops),
            hbm_bytes=float(counter.hbm_bytes),
            coll_bytes=float(coll["total"]),
            model_flops=rl.model_flops_for(shape.kind, total, active, tokens),
            chips=chips,
            coll_seconds=counter.collective_seconds(sizes),
        )
        result.update(
            status="ok",
            seconds_run=round(time.time() - t0, 1),
            memory=counter.memory(),
            collectives=coll,
            collectives_by_axis=_by_axis(counter),
            roofline=roof.to_dict(),
            params_total=total,
            params_active=active,
            tokens=tokens,
            shape_config=dataclasses.asdict(shape),
        )
    except Exception as e:  # record the failure — dry-run bugs are OUR bugs
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    _write(out_dir, result)
    return result


def _by_axis(counter) -> dict:
    out: dict = {}
    for _, size, axis in counter.collectives:
        out[axis] = out.get(axis, 0) + size
    return out


def _write(out_dir: Path, result: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    if result.get("variant"):
        name = name.replace(".json", f"__{result['variant']}.json")
    (out_dir / name).write_text(json.dumps(result, indent=1))


# --------------------------------------------------------------------------- CLI


def _pairs(items) -> dict:
    """``KEY=VALUE`` strings as a dict, values read as JSON where they
    parse (numbers), else as strings."""
    out = {}
    for item in items or ():
        key, _, value = item.partition("=")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=ARCH_IDS, nargs="+",
                    help="one arch or several (all when absent)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "test", "one"])
    ap.add_argument("--all", action="store_true", help="all archs x shapes")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs on a small test mesh (CI)")
    ap.add_argument("--variant", default="", choices=[""] + list(VARIANTS),
                    help="a named config delta")
    ap.add_argument("--shape-set", nargs="*", metavar="KEY=VALUE",
                    help="override the shape's fields (seq_len=2048)")
    ap.add_argument("--train-set", nargs="*", metavar="KEY=VALUE",
                    help="override TrainConfig fields (microbatches=2)")
    args = ap.parse_args(argv)
    # DTensor's advice on nested reductions, once a redistribution
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    out = Path(args.out)
    archs = ARCH_IDS if (args.all or args.arch is None) else tuple(args.arch)
    shapes = list(SHAPES) if (args.all or args.shape is None) else (args.shape,)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_name in meshes:
        mesh = make_mesh(mesh_name)
        for arch in archs:
            for shape_name in shapes:
                r = run_cell(arch, shape_name, mesh_name, out,
                             reduced=args.reduced, mesh=mesh,
                             variant=args.variant,
                             shape_overrides=_pairs(args.shape_set),
                             train_overrides=_pairs(args.train_set))
                line = (f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:6s} "
                        f"{args.variant or '-':8s} {r['status']}")
                if r["status"] == "ok":
                    roof = r["roofline"]
                    line += (
                        f" bottleneck={roof['bottleneck']:10s}"
                        f" t={roof['t_bound_s'] * 1e3:9.2f}ms"
                        f" peak/dev={r['memory']['peak_estimate_bytes'] / 2**30:7.2f}GiB"
                        f" run={r['seconds_run']:.0f}s"
                    )
                elif r["status"] == "error":
                    failures += 1
                    line += f" {r['error'][:200]}"
                else:
                    line += f" ({r['reason'][:80]})"
                print(line, flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
