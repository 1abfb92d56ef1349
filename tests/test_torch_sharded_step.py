"""The port's train step in the rules' layout, on gloo ranks (one process a
rank), against the JAX package.

- On a (2, 2) ("data", "model") mesh, the reduced ``granite_3_2b``: the
  state in the rules' layout (``shard_train_state``: every parameter, both
  moments as DTensors of the ``Partitioner``'s placements), two steps
  with ``grad_shardings=`` (the reference's pin: each gradient
  redistributed to its parameter's placements, a reduce-scatter out of
  ``Partial``). The parameters (``full_tensor()``), moments and metrics
  after one step match the JAX package's step on the same parameters
  and batch at the bounds ``tests/test_torch_train.py`` holds the port's
  step to, and after two the port's mesh-less step at the bounds of
  ``tests/test_torch_train_mesh.py`` (two steps of the plain port drift
  from the reference past the first bounds: 1.5e-4 of the update at
  ``wk``); every rank holds exactly its rules' shard of each leaf, before
  and after.
- The int8 cross-pod step on (2, 1, 2) ("pod", "data", "model") against
  the JAX package's compressed step jitted on a (2, 1, 2) mesh of forced
  host devices, at that file's bounds for the int8 step (flips allowed;
  the share of flipped residual elements bounded as there, under 1%,
  with a floor of 3 elements for the 128-element gain vectors, where one
  seed's pod saw 3): one scale a reference leaf over the whole leaf,
  across its shards over 'model'.
- One step on the (2, 2) gloo mesh counted on rank 0's local tensors
  (``roofline.DeviceCounter``, with ``CommDebugMode`` beside it): its
  FLOPs, its collectives' bytes by kind and their count equal the
  dry-run's per-device record of the same cell on a fake group of 4
  ranks, exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.train import optimizer as jax_opt
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.train import checkpoint as ckpt
from test_torch_train_mesh import (
    JAX_STEP, TCFG, _assert_steps_agree, _metrics_agree, _params0,
)
from test_torch_train_mesh import RANK_SCRIPT as MESH_RANK_SCRIPT
from torch_ranks import run_jax, run_ranks

OLD_RESIDUAL = """    for shard in v.addressable_shards:   # each pod's own residual
        pod = int(np.argwhere(mesh.devices == shard.device)[0][0])
        out[f"{key}@{pod}"] = np.asarray(shard.data, np.float32)"""
NEW_RESIDUAL = """    whole = {}                           # each pod's own residual
    for shard in v.addressable_shards:
        pod = int(np.argwhere(mesh.devices == shard.device)[0][0])
        arr = whole.setdefault(pod, np.zeros(v.shape, np.float32))
        arr[shard.index] = np.asarray(shard.data, np.float32)
    for pod, arr in whole.items():
        out[f"{key}@{pod}"] = arr"""

ROOT = Path(__file__).resolve().parent.parent
assert OLD_RESIDUAL in JAX_STEP
# the reference's compressed step on (2, 1, 2): each pod's residual put
# together from its shards over 'model'
JAX_POD_STEP = JAX_STEP.replace(
    "make_test_mesh((2, 1, 1)", "make_test_mesh((2, 1, 2)").replace(
    OLD_RESIDUAL, NEW_RESIDUAL)
ARCH = "granite_3_2b"
BATCH, SEQ = 4, 16

RANK_SCRIPT = r"""
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import make_test_mesh
from repro_torch.launch.partitioning import (
    Partitioner, param_shardings, shard_slices)
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainState, make_train_step, shard_train_state)

def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

bundle = build_model(get_config(SPEC["arch"]).reduce(), "cpu")
tcfg = TrainConfig(**SPEC["tcfg"])
model, _ = ckpt.load_checkpoint(SPEC["ckpt"], {"params": bundle.skeleton(trainable=True)})
model = model["params"]
before = {n: p.detach().clone() for n, p in model.named_parameters()}
state = TrainState(model, opt.adamw_init(model, tcfg))
mesh = make_test_mesh(tuple(SPEC["mesh"]), tuple(SPEC["names"]), device="cpu")
state = shard_train_state(state, bundle, mesh)
shardings = param_shardings(bundle, mesh)
coord = mesh.get_coordinate()

def own_shards(tree, want):
    # every rank holds exactly the slice its rules give it
    for n, t in tree.items():
        assert isinstance(t, DTensor), n
        assert tuple(t.placements) == tuple(shardings[n].placements), n
        mine = want[n][shard_slices(want[n].shape, shardings[n], coord)]
        assert torch.equal(t.to_local(), mine.to(t.dtype)), n

own_shards(dict(state.params.named_parameters()), before)
grad_shardings = Partitioner(mesh).tree_shardings(bundle.abstract(), bundle.axes)
step = make_train_step(bundle, tcfg, mesh=mesh, pod_axis="pod",
                       grad_shardings=grad_shardings)
out = {}
quantize = opt.quantize_grads_with_feedback
def recording(grads, residual, **kw):   # each leaf's scale, step by step
    q, scales, resid = quantize(grads, residual, **kw)
    for k, v in scales.items():
        out[f"scale:{i}:{k}"] = v.numpy()
    return q, scales, resid
opt.quantize_grads_with_feedback = recording
batches = np.load(SPEC["batches"])
for i in range(SPEC["steps"]):
    batch = {k: torch.from_numpy(batches[k][i]) for k in ("tokens", "targets")}
    state, metrics = step(state, batch)
    for k, v in metrics.items():
        out[f"metric:{i}:{k}"] = v.numpy()
    if i == 0:
        out.update({"mu1:" + k: v.float().numpy().copy() for k, v in
                    ckpt.reference_layout(state.opt.mu).items()
                    for v in [torch.stack([full(t) for t in v[0]])
                              if v[1] else full(v[0][0])]})
        for k, (ts, st) in ckpt.reference_layout(
                {"params": state.params, "mu": state.opt.mu}).items():
            ts = [full(t.detach()) for t in ts]
            out["s0:" + k] = (torch.stack(ts) if st else ts[0]).float().numpy()
leaves = dict(state.params.named_parameters())
own_shards(leaves, {n: full(p.detach()) for n, p in leaves.items()})
own_shards(state.opt.mu, {n: full(t) for n, t in state.opt.mu.items()})
tree = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}
if state.opt.residual is not None:
    tree["residual"] = state.opt.residual
for k, (ts, st) in ckpt.reference_layout(tree).items():
    ts = [full(t.detach()) for t in ts]
    out[k] = (torch.stack(ts) if st else ts[0]).float().numpy()
np.savez(OUT, **out)
"""

COUNT_SCRIPT = r"""
import json
import torch
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import make_test_mesh
from repro_torch.launch.partitioning import Partitioner
from repro_torch.launch.roofline import DeviceCounter
from repro_torch.models import build_model
from repro_torch.train import init_train_state
from repro_torch.train.train_step import (
    _batch_block, make_train_step, shard_train_state)

cfg = get_config(SPEC["arch"]).reduce(param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
bundle = build_model(cfg, "cpu")
tcfg = TrainConfig()
mesh = make_test_mesh(tuple(SPEC["mesh"]), tuple(SPEC["names"]), device="cpu")
state = shard_train_state(init_train_state(
    bundle, tcfg, torch.Generator().manual_seed(0)), bundle, mesh)
toks = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (SPEC["batch"], SPEC["seq"] + 1))
batch = _batch_block(
    {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
     "targets": torch.as_tensor(toks[:, 1:], dtype=torch.int32)},
    mesh, ("data",))
step = make_train_step(bundle, tcfg, mesh=mesh, pod_axis="pod",
                       grad_shardings=Partitioner(mesh).tree_shardings(
                           bundle.abstract(), bundle.axes))
counter = DeviceCounter(mesh)
with CommDebugMode() as comm, counter:
    step(state, batch)
np.savez(OUT, flops=np.array(counter.flops),
         coll=np.array(json.dumps(counter.collective_bytes())),
         comm=np.array(comm.get_total_counts()))
"""

DRYRUN_SCRIPT = r"""
import json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
spec = json.loads(sys.argv[1])
dryrun.fake_world(4)
mesh = make_test_mesh(tuple(spec["mesh"]), tuple(spec["names"]), device="cpu")
cfg = get_config(spec["arch"]).reduce(param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
shape = SHAPES["train_4k"].__class__("train_4k", seq_len=spec["seq"],
                                     global_batch=spec["batch"], kind="train")
counter, _ = dryrun.execute_cell(cfg, shape, mesh, spec["arch"])
print(json.dumps({"flops": counter.flops,
                  "coll": counter.collective_bytes()}))
"""


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The reference's parameters as a port checkpoint, the batches, and
    the JAX package's plain step on them (params, moments, metrics)."""
    tmp = tmp_path_factory.mktemp("sharded_step")
    jb = jax_build(jax_config(ARCH).reduce())
    jparams = jb.init(jax.random.key(0))
    pb = build_model(get_config(ARCH).reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            pb.skeleton(trainable=True))
    ckpt.save_checkpoint(tmp / "ckpt", 0, {"params": model})
    rng = np.random.default_rng(0)
    vocab = pb.cfg.vocab_size
    np.savez(tmp / "batches.npz",
             tokens=rng.integers(0, vocab, (3, BATCH, SEQ)).astype(np.int32),
             targets=rng.integers(0, vocab, (3, BATCH, SEQ)).astype(np.int32))
    return {"arch": ARCH, "tcfg": TCFG, "ckpt": str(tmp / "ckpt"),
            "batches": str(tmp / "batches.npz"), "jparams": jparams,
            "jb": jb}


def _jax_plain(shared, steps) -> dict:
    """The JAX package's step, no mesh, ``steps`` steps: the state by the
    port's reference-layout keys, the metrics, and the first moments
    after one step."""
    jb = shared["jb"]
    tcfg = JaxTrainConfig(**TCFG)
    params = shared["jparams"]
    state = JaxTrainState(params, jax_opt.adamw_init(params, tcfg))
    step = jax.jit(jax_make_train_step(jb, tcfg))
    batches = np.load(shared["batches"])
    out = {}

    def flat(prefix, tree):
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            yield f"{prefix}/{key}", np.asarray(v, np.float32)

    for i in range(steps):
        batch = {k: jnp.asarray(batches[k][i]) for k in ("tokens", "targets")}
        state, metrics = step(state, batch)
        out.update({f"metric:{i}:{k}": np.asarray(v)
                    for k, v in metrics.items()})
        if i == 0:
            out.update({"mu1:" + k.removeprefix("mu/"): v
                        for k, v in flat("mu", state.opt.mu)})
    for field, tree in (("params", state.params), ("mu", state.opt.mu),
                        ("nu", state.opt.nu)):
        out.update(dict(flat(field, tree)))
    return out


def _spec(shared, **kw) -> dict:
    return {k: v for k, v in {**shared, **kw}.items()
            if k not in ("jparams", "jb")}


def test_sharded_step_matches_the_reference(tmp_path, shared):
    """One step against the JAX package's at ``tests/test_torch_train.py``'s
    bounds (the port's plain step against the reference), two against the
    port's mesh-less step at ``tests/test_torch_train_mesh.py``'s."""
    steps = 2
    want = _jax_plain(shared, 1)
    plain = run_ranks(tmp_path / "plain", 1, MESH_RANK_SCRIPT, {
        **_spec(shared), "mesh": None, "steps": steps})[0]
    ranks = run_ranks(tmp_path, 4, RANK_SCRIPT, _spec(
        shared, mesh=[2, 2], names=["data", "model"], steps=steps))
    before = _params0(shared)
    for got in ranks:
        first = {k.removeprefix("s0:"): v for k, v in got.items()
                 if k.startswith("s0:")}
        first.update({k: v for k, v in got.items() if k.startswith("mu1:")})
        first.update({k: v for k, v in got.items()
                      if k.startswith("metric:0:")})
        _metrics_agree(first, want, 1)
        mu1 = ({k: v for k, v in got.items() if k.startswith("mu1:")},
               {k: v for k, v in want.items() if k.startswith("mu1:")})
        assert mu1[1] and set(mu1[0]) == set(mu1[1])
        _assert_steps_agree(first, want, before, 1, mu1)
        _metrics_agree(got, plain, steps)
        _assert_steps_agree(got, plain, before, steps)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[3][k], err_msg=k)


def test_int8_cross_pod_step_on_a_model_axis_matches_the_reference(
        tmp_path, shared):
    steps, b1 = 3, 0.9
    want = run_jax(tmp_path, 4, JAX_POD_STEP, {**_spec(shared),
                                              "steps": steps})
    ranks = run_ranks(tmp_path, 4, RANK_SCRIPT, _spec(
        shared, tcfg={**TCFG, "grad_compression": "int8"}, mesh=[2, 1, 2],
        names=["pod", "data", "model"], steps=steps))
    before = {k.replace("params0/", "params/", 1): v for k, v in want.items()
              if k.startswith("params0/")}
    lr = TCFG["learning_rate"]
    for rank, got in enumerate(ranks):
        pod = rank // 2
        _metrics_agree(got, want, steps, norm_rtol=1e-3)
        for k in before:
            leaf = k.removeprefix("params/")
            flip = [sum(float(r[f"scale:{i}:{leaf}"]) for r in ranks)
                    / len(ranks) for i in range(steps)]
            bound = sum((1 - b1) * b1 ** (steps - 1 - i) * f
                        for i, f in enumerate(flip))
            mu = "mu/" + leaf
            dmu = np.abs(got[mu] - want[mu])
            top = np.abs(want[mu]).max()
            assert dmu.max() <= bound + 1e-5 * top, mu
            assert dmu.max() <= 1e-2 * top, mu
            np.testing.assert_allclose(got[k], want[k], atol=lr * steps,
                                       rtol=0, err_msg=k)
            res = "residual/" + leaf
            step = float(got[f"scale:{steps - 1}:{leaf}"])
            dres = np.abs(got[res] - want[f"{res}@{pod}"])
            assert dres.max() <= step * (1 + 1e-3), res
            # flips: under 1% of a leaf's elements (0.78% at most in the
            # large leaves), or 3 of a 128-element gain vector
            assert (dres > step / 4).sum() <= max(0.01 * dres.size, 3), res
    # the ranks of a pod agree on their scales (one a whole leaf)
    for k in ranks[0]:
        if k.startswith("scale:"):
            assert ranks[0][k] == ranks[1][k], k


def test_counts_on_gloo_ranks_equal_the_dry_run(tmp_path):
    spec = {"arch": ARCH, "mesh": [2, 2], "names": ["data", "model"],
            "batch": 8, "seq": 32}
    rank0 = run_ranks(tmp_path, 4, COUNT_SCRIPT, spec)[0]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c",
                           DRYRUN_SCRIPT, json.dumps(spec)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    coll = json.loads(str(rank0["coll"]))
    assert record["flops"] > 0 and coll["total"] > 0
    assert int(rank0["flops"]) == record["flops"]
    assert coll == record["coll"]
    assert int(rank0["comm"]) == record["coll"]["count"]
