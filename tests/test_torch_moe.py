"""The port's MoE layer (``models/moe.py``) against the JAX package's on
the CPU.

The reference's own setup (``tests/test_moe.py:16``): ``dbrx_132b``
reduced to 4 experts, top 2, d 32, F 64, its parameters from the JAX
package's init and carried across by ``load_tree``, inputs from
``np.random.default_rng(0)``; and an ``arctic_480b`` ``.reduce()`` for the
dense residual. Held:

- the routing itself, index-exact: each (token, slot) pair's expert, its
  rank within the expert and the keep mask, ties included (``top_k`` takes
  the lower index first, as ``jax.lax.top_k``);
- ``y``, ``lb`` and ``z`` at ``atol=rtol=1e-5`` at the published
  ``capacity_factor`` (1.25) and at 0.05, where most pairs drop;
- ``_capacity`` for every MoE config, and the aux losses' floors;
- the layer's gradients and the whole model's ``loss_fn`` gradients
  against ``jax.grad``, within 1e-3 relative L2 a leaf, router included
  (``tests/test_torch_loss.py``'s bound);
- remat (a checkpoint per layer group, the aux losses leaving it beside
  the activations) changes no bit of the MoE loss or its gradients.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.layers import init_params as jax_init_params
from repro.models.moe import EPContext as JaxEPContext
from repro.models.moe import _capacity as jax_capacity
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_specs as jax_moe_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import EPContext, build_model, params_from_jax
from repro_torch.models.convert import load_tree
from repro_torch.models.layers import ParamTree
from repro_torch.models.moe import _capacity, _route, moe_apply, moe_specs
from repro_torch.train.checkpoint import reference_layout

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 1e-3
MOE = [a for a in ARCH_IDS if get_config(a).is_moe]
SMALL = dict(num_experts=4, top_k=2, d_model=32, d_ff=64, vocab_size=128)


def _cfgs(arch, capacity_factor=None):
    """(reference config, port config): the reference test's small dbrx,
    or arctic's ``.reduce()`` (dense residual), at ``capacity_factor``."""
    kw = SMALL if arch == "dbrx_132b" else {}
    jcfg, cfg = jax_config(arch).reduce(**kw), get_config(arch).reduce(**kw)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return jcfg, cfg


def _setup(arch, capacity_factor=None, trainable=False):
    jcfg, cfg = _cfgs(arch, capacity_factor)
    jparams = jax_init_params(jax_moe_specs(jcfg), jax.random.key(0),
                              jnp.float32)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    params = load_tree(ParamTree(moe_specs(cfg), torch.float32, "cpu",
                                 trainable), tree)
    x = np.random.default_rng(0).normal(size=(4, 8, jcfg.d_model)) \
        .astype(np.float32)
    return jcfg, cfg, jparams, params, x


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_routing(x2d, router, cfg, capacity):
    """The reference's routing lines (``repro/models/moe.py:83-93``)."""
    logits = x2d.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, cfg.top_k)
    flat_ids = expert_ids.reshape(-1)
    onehot = jax.nn.one_hot(flat_ids, cfg.num_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return flat_ids, pos, pos < capacity


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("tokens", [1, 4, 100, 8192, 65536])
def test_capacity_matches_the_reference(arch, tokens):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert _capacity(tokens, cfg) == jax_capacity(tokens, jcfg)
    assert _capacity(tokens, cfg) == max(int(np.ceil(
        cfg.capacity_factor * cfg.top_k * tokens / cfg.num_experts)), 1)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.05])
def test_routing_is_index_exact(arch, capacity_factor):
    jcfg, cfg, jparams, params, x = _setup(arch, capacity_factor)
    x2d = x.reshape(-1, jcfg.d_model)
    x2d[:3] = 0.0        # equal probabilities: ties, the lower index first
    cap = _capacity(x2d.shape[0], cfg)
    r = _route(torch.from_numpy(x2d), params["router"], cfg, cap)
    ids, pos, keep = _jax_routing(jnp.asarray(x2d), jparams["router"], jcfg,
                                  cap)
    np.testing.assert_array_equal(r.ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(r.pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r.ids[:3 * cfg.top_k].numpy(),
                                  np.tile(np.arange(cfg.top_k), 3))
    if capacity_factor < 1:
        assert not bool(r.keep.all())


@pytest.mark.parametrize("arch", MOE)
def test_imposed_routing_recomputes_gates_and_ranks(arch):
    _, cfg, _, params, x = _setup(arch, 0.05)
    x2d = torch.from_numpy(x.reshape(-1, cfg.d_model))
    cap = _capacity(x2d.shape[0], cfg)
    r = _route(x2d, params["router"], cfg, cap)
    # its own experts imposed: the same routing, bit for bit
    for name, want, got in zip(r._fields, r,
                               _route(x2d, params["router"], cfg, cap,
                                      ids=r.ids)):
        assert torch.equal(got, want), name
    # each pair's expert moved to the next one: the gates read from the
    # probabilities there, the ranks counted anew in token-major order
    other = (r.ids + 1) % cfg.num_experts
    got = _route(x2d, params["router"], cfg, cap, ids=other)
    gates = r.probs.gather(1, other.reshape(-1, cfg.top_k))
    assert torch.equal(got.ids, other)
    assert torch.equal(got.gates, gates / gates.sum(-1, keepdim=True))
    seen = collections.Counter()
    pos = []
    for e in other.tolist():
        pos.append(seen[e])
        seen[e] += 1
    assert got.pos.tolist() == pos
    assert torch.equal(got.keep, torch.tensor(pos) < cap)
    assert not bool(got.keep.all())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [None, 0.05])
def test_moe_apply_matches_the_reference(arch, capacity_factor):
    jcfg, cfg, jparams, params, x = _setup(arch, capacity_factor)
    y, aux = moe_apply(params, torch.from_numpy(x), cfg)
    jy, jaux = jax_moe_apply(jparams, jnp.asarray(x), jcfg, JaxEPContext())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    for k in ("lb", "z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL,
                                   err_msg=k)


def test_capacity_drops_tokens():
    _, cfg, _, params, x = _setup("dbrx_132b")
    tiny = dataclasses.replace(cfg, capacity_factor=0.05)
    y_tiny, _ = moe_apply(params, torch.from_numpy(x), tiny)
    y_full, _ = moe_apply(params, torch.from_numpy(x), cfg)
    # drops change the output (some tokens lost their expert contribution)
    assert not torch.allclose(y_tiny, y_full)
    assert bool(torch.isfinite(y_tiny).all())


@pytest.mark.parametrize("arch", MOE)
def test_aux_losses_positive(arch):
    _, cfg, _, params, x = _setup(arch)
    _, aux = moe_apply(params, torch.from_numpy(x), cfg, EPContext())
    assert float(aux["lb"]) >= 1.0 - 1e-3   # ==1 at perfect balance
    assert float(aux["z"]) >= 0.0


@pytest.mark.parametrize("arch", MOE)
def test_moe_gradients_match_jax_grad(arch):
    """``sum(y**2) + lb`` (the reference's ``test_moe_grads_flow`` loss)
    through both packages: every parameter's gradient within 1e-3
    relative L2 of ``jax.grad``'s, the router's non-zero."""
    jcfg, cfg, jparams, params, x = _setup(arch, trainable=True)

    def jloss(p):
        y, aux = jax_moe_apply(p, jnp.asarray(x), jcfg, JaxEPContext())
        return jnp.sum(y ** 2) + aux["lb"]

    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.grad(jloss)(jparams))[0]}
    y, aux = moe_apply(params, torch.from_numpy(x), cfg)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad((y ** 2).sum() + aux["lb"], leaves)
    got = {n.replace(".", "/"): g.numpy() for n, g in zip(names, grads)}
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) < GRAD_REL_L2, k
    assert float(np.abs(got["router"]).sum()) > 0


def _model_setup(arch, **overrides):
    jcfg = jax_config(arch).reduce()
    jb = jax_build(jcfg)
    params = jb.init(jax.random.key(1))
    pb = build_model(get_config(arch).reduce(**overrides), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            pb.skeleton(trainable=True))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)}
    return jb, params, pb, model, batch


@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_gradients_match_the_reference(arch):
    """The whole reduced model's ``loss_fn``: the loss, ``moe_lb`` and
    ``moe_z`` at 1e-5 and every parameter's gradient (the routers' and the
    experts' ``(L, E, D, F)`` leaves stacked back into the reference's
    layout) within 1e-3 relative L2 of ``jax.value_and_grad``'s."""
    jb, params, pb, model, batch = _model_setup(arch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = pb.loss_fn(model, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert set(metrics) == set(jm) == {"nll", "accuracy", "loss", "moe_lb",
                                       "moe_z"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(jm[k]), **TOL, err_msg=k)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    got = {k: (torch.stack(ts) if st else ts[0]).numpy()
           for k, (ts, st) in reference_layout(grads).items()}
    want = {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel_l2(got[k], want[k]) < GRAD_REL_L2, k
    assert any("router" in k for k in want)


@pytest.mark.parametrize("arch", MOE)
def test_remat_changes_no_bit_of_the_moe_loss(arch):
    _, _, pb, model, batch = _model_setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = build_model(get_config(arch).reduce(remat="none"), "cpu")
    out = []
    for bundle in (pb, plain):
        loss, metrics = bundle.loss_fn(model, batch)
        out.append((loss, metrics["moe_lb"], metrics["moe_z"],
                    torch.autograd.grad(loss, list(model.parameters()))))
    (la, lba, za, ga), (lb, lbb, zb, gb) = out
    assert torch.equal(la, lb) and torch.equal(lba, lbb) and torch.equal(za, zb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
