"""The port's train step on a mesh, on gloo ranks (one process a rank).

- The reduced ``granite_3_2b`` on ``(pod, data, model) = (1, 2, 1)``: each
  rank takes half of every batch and the gradients are averaged over
  ``data``; the first moment after one step (the gradient, scaled by 1 -
  beta1) and the parameters and moments after two steps must match the
  mesh-less step on the whole batch, at the bounds
  ``tests/test_torch_train.py`` holds a step to against the reference
  (first moment within 1e-4 relative L2, the update within 1e-4 where the
  gradient is well above Adam's epsilon, every parameter within the
  learning rate a step), and the metrics at 1e-5.
- On ``(2, 1, 1)`` with ``grad_compression="int8"``: the compressed
  cross-pod step (int8 all-gather of the gradients with error feedback),
  3 steps, against the JAX package's compressed step jitted on a (2, 1,
  1) mesh of forced host devices, on the same parameters (the
  reference's, through ``params_from_jax``) and the same batches. The
  int8 rounding makes the comparison discontinuous: where the two
  packages' float32 gradients straddle a rounding boundary, a value
  rounds to the neighbouring integer (a flip), the pod's residual moves by
  one quantisation step (the leaf's scale, recorded on the port's side)
  and the mean gradient by the scale over the pod count, which error
  feedback hands back a step later. So the bounds of
  ``tests/test_torch_train.py`` (the first moment within 1e-4 relative
  L2) do not hold here, and the state is held to what flips allow: every
  parameter within the learning rate a step (that file's bound); every
  first-moment element within the sum over steps of ``(1 - beta1)
  beta1^k`` times the mean flip, and within 1e-2 of the leaf's largest;
  each pod's residual, against the one the reference keeps on that pod's
  device, within one quantisation step elementwise (and a thousandth of
  it for the float32 gradients' own difference) and off by more than
  a quarter step in under 1% of its elements; the loss, NLL, accuracy
  and learning rate at 1e-5 and the gradient norm (of the dequantized
  mean, which flips move) at 1e-3.

Both mesh cases hold the state in the rules' layout
(``shard_train_state``); each leaf is gathered (``full_tensor()``) to be
compared, each pod's residual being its own.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build_model, params_from_jax
from repro_torch.train import make_train_step
from repro_torch.train import checkpoint as ckpt
from torch_ranks import run_jax, run_ranks

ARCH = "granite_3_2b"
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
BATCH, SEQ = 4, 16

RANK_SCRIPT = r"""
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import make_test_mesh
from repro_torch.models import build_model, params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainState, make_train_step, shard_train_state)
from torch.distributed.tensor import DTensor

def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

bundle = build_model(get_config(SPEC["arch"]).reduce(), "cpu")
tcfg = TrainConfig(**SPEC["tcfg"])
model, _ = ckpt.load_checkpoint(SPEC["ckpt"], {"params": bundle.skeleton(trainable=True)})
model = model["params"]
state = TrainState(model, opt.adamw_init(model, tcfg))
batches = np.load(SPEC["batches"])
if SPEC["mesh"] is None:
    step = make_train_step(bundle, tcfg)
else:
    mesh = make_test_mesh(tuple(SPEC["mesh"]), ("pod", "data", "model"), device="cpu")
    state = shard_train_state(state, bundle, mesh)
    step = make_train_step(bundle, tcfg, mesh=mesh, pod_axis="pod")
out = {}
quantize = opt.quantize_grads_with_feedback
def recording(grads, residual, **kw):   # each leaf's scale, step by step
    q, scales, resid = quantize(grads, residual, **kw)
    for k, v in scales.items():
        out[f"scale:{i}:{k}"] = v.numpy()
    return q, scales, resid
opt.quantize_grads_with_feedback = recording
for i in range(SPEC["steps"]):
    batch = {k: torch.from_numpy(batches[k][i]) for k in ("tokens", "targets")}
    state, metrics = step(state, batch)
    for k, v in metrics.items():
        out[f"metric:{i}:{k}"] = v.numpy()
    if i == 0:
        # copies: a float32 moment's .float() is the live tensor
        out.update({"mu1:" + k: v.float().numpy().copy() for k, v in
                    ckpt.reference_layout(state.opt.mu).items()
                    for v in [torch.stack([full(t) for t in v[0]])
                              if v[1] else full(v[0][0])]})
tree = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}
if state.opt.residual is not None:
    tree["residual"] = state.opt.residual
for k, (ts, st) in ckpt.reference_layout(tree).items():
    ts = [full(t.detach()) for t in ts]
    out[k] = (torch.stack(ts) if st else ts[0]).float().numpy()
np.savez(OUT, **out)
"""

JAX_STEP = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.train import optimizer as opt
from repro.train.train_step import TrainState, make_train_step
from repro.jax_compat import set_mesh

bundle = build_model(get_config(SPEC["arch"]).reduce())
params = bundle.init(jax.random.key(0))
tcfg = TrainConfig(**SPEC["tcfg"], grad_compression="int8")
state = TrainState(params, opt.adamw_init(params, tcfg))
mesh = make_test_mesh((2, 1, 1), ("pod", "data", "model"))
batches = np.load(SPEC["batches"])
step = jax.jit(make_train_step(bundle, tcfg, mesh=mesh, pod_axis="pod"))
out = {}

def flat(prefix, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        yield f"{prefix}/{key}", v

with set_mesh(mesh):
    for i in range(SPEC["steps"]):
        batch = {k: jnp.asarray(batches[k][i]) for k in ("tokens", "targets")}
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            out[f"metric:{i}:{k}"] = np.asarray(v)
for key, v in flat("params", state.params):
    out[key] = np.asarray(v, np.float32)
for field in ("mu", "nu"):
    for key, v in flat(field, getattr(state.opt, field)):
        out[key] = np.asarray(v, np.float32)
for key, v in flat("residual", state.opt.residual):
    for shard in v.addressable_shards:   # each pod's own residual
        pod = int(np.argwhere(mesh.devices == shard.device)[0][0])
        out[f"{key}@{pod}"] = np.asarray(shard.data, np.float32)
for key, v in flat("params0", params):
    out[key] = np.asarray(v, np.float32)
np.savez(OUT, **out)
"""


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The reference's parameters as a port checkpoint, and the batches."""
    tmp = tmp_path_factory.mktemp("train_mesh")
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
            "batches": str(tmp / "batches.npz")}


def _assert_steps_agree(got: dict, want: dict, before: dict, steps: int,
                        mu1=None):
    """Parameters and moments after ``steps`` steps, by the bounds of
    ``tests/test_torch_train.py``; ``mu1`` (got, want) the first moments
    after one step."""
    lr = TCFG["learning_rate"]
    params = [k for k in want if k.startswith("params/")]
    assert params
    for k in params:
        mu = k.replace("params/", "mu/", 1)
        assert _rel_l2(got[mu], want[mu]) < 1e-4, mu
        firm = np.abs(want[mu]) > (1 - 0.9) * 1e-6
        assert _rel_l2((got[k] - before[k])[firm],
                       (want[k] - before[k])[firm]) < 1e-4, k
        np.testing.assert_allclose(got[k], want[k], atol=lr * steps, rtol=0,
                                   err_msg=k)
    if mu1 is not None:
        for k in mu1[1]:
            assert _rel_l2(mu1[0][k], mu1[1][k]) < 1e-4, k


def _metrics_agree(got: dict, want: dict, steps: int, norm_rtol=1e-4):
    for i in range(steps):
        keys = {k for k in want if k.startswith(f"metric:{i}:")}
        assert keys and keys == {k for k in got if k.startswith(f"metric:{i}:")}
        for k in keys:
            rtol = norm_rtol if k.endswith("grad_norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_data_parallel_step_matches_the_mesh_less_step(tmp_path, shared):
    plain = run_ranks(tmp_path / "plain", 1, RANK_SCRIPT,
                      {**shared, "mesh": None, "steps": 2})[0]
    ranks = run_ranks(tmp_path, 2, RANK_SCRIPT,
                      {**shared, "mesh": [1, 2, 1], "steps": 2})
    for got in ranks:
        _metrics_agree(got, plain, 2)
        mu1 = ({k: v for k, v in got.items() if k.startswith("mu1:")},
               {k: v for k, v in plain.items() if k.startswith("mu1:")})
        assert mu1[1]
        _assert_steps_agree(got, plain, _params0(shared), 2, mu1)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def _params0(shared) -> dict:
    like = build_model(get_config(ARCH).reduce(), "cpu").skeleton()
    model, _ = ckpt.load_checkpoint(shared["ckpt"], {"params": like})
    return {k: (torch.stack(ts) if st else ts[0]).detach().float().numpy()
            for k, (ts, st) in ckpt.reference_layout(model).items()}


def test_int8_cross_pod_step_matches_the_reference(tmp_path, shared):
    steps, b1 = 3, 0.9
    want = run_jax(tmp_path, 2, JAX_STEP, {**shared, "steps": steps})
    ranks = run_ranks(tmp_path, 2, RANK_SCRIPT, {
        **shared, "tcfg": {**TCFG, "grad_compression": "int8"},
        "mesh": [2, 1, 1], "steps": steps})
    before = {k.replace("params0/", "params/", 1): v for k, v in want.items()
              if k.startswith("params0/")}
    lr = TCFG["learning_rate"]
    for pod, got in enumerate(ranks):
        _metrics_agree(got, want, steps, norm_rtol=1e-3)
        for k in before:
            leaf = k.removeprefix("params/")
            # a flip moves step i's mean gradient by a pod's scale over the
            # pod count in one element, and the first moment by (1 - b1)
            # b1^(steps - 1 - i) times that
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
            assert np.abs(want[f"{res}@{pod}"]).max() > 0, res
            # a flip and the float32 gradients' own difference
            assert dres.max() <= step * (1 + 1e-3), res
            assert (dres > step / 4).mean() < 0.01, res
    # the pods' parameters are the same; their residuals are their own
    for k in ranks[0]:
        if not k.startswith(("residual/", "scale:")):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    assert any(not np.array_equal(ranks[0][k], ranks[1][k])
               for k in ranks[0] if k.startswith("residual/"))
