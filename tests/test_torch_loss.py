"""The port's ``ModelBundle.loss_fn`` and its gradients against the JAX
package on the CPU.

For each reduced arch the port ports (the dense archs, RecurrentGemma and
Mamba-2) the reference's parameters reach the port through
``params_from_jax`` (built trainable), the same numpy batch goes through
both ``loss_fn`` s, and ``torch.autograd.grad`` is held against
``jax.value_and_grad``: the loss and its metrics at 1e-5, every
parameter's gradient, stacked back into the reference's layout, within
1e-3 in relative L2 (float32 sums in other orders through the layers,
the softcaps and the recurrences; the worst reading is about 1.6e-4, in
recurrentgemma and gemma2). On the CPU the sequence attention, the SSD
mixer and the RG-LRU scan take their plain versions forward and backward
(``attention_bwd_ref``; the plain chunked SSD differentiated; the plain
scan run backwards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.model import default_positions as jax_positions
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.model import default_positions
from repro_torch.train.checkpoint import reference_layout

ARCHS = ["gemma2_2b", "granite_3_2b", "qwen3_8b", "chatglm3_6b",
         "qwen2_vl_7b", "recurrentgemma_2b", "mamba2_1_3b"]
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 1e-3


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _setup(arch, seed=0):
    jcfg = jax_config(arch).reduce()
    jb = jax_build(jcfg)
    params = jb.init(jax.random.key(1))
    pb = build_model(get_config(arch).reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            pb.skeleton(trainable=True))
    rng = np.random.default_rng(seed)
    # past gemma2's reduced window of 32, so the local mask bites
    s = 48 if "local_attn" in jcfg.block_pattern else 24
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if jcfg.rope_mode == "mrope":
        jbatch["positions"] = jax_positions(jcfg, 2, s)
        pbatch["positions"] = default_positions(pb.cfg, 2, s)
    return jb, params, pb, model, jbatch, pbatch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    jb, params, pb, model, jbatch, pbatch = _setup(arch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))(
        params, jbatch)
    loss, metrics = pb.loss_fn(model, pbatch)
    assert set(metrics) == set(jm) == {"nll", "accuracy", "loss"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(jm[k]), **LOSS_TOL, err_msg=k)
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


@pytest.mark.parametrize("arch", ["gemma2_2b", "recurrentgemma_2b"])
def test_remat_changes_no_bit(arch):
    """``remat="block"`` (a checkpoint around each scan group, the
    default) recomputes the group's forward in the backward; the loss and
    every gradient are those of ``remat="none"``, bit for bit."""
    _, _, pb, model, _, pbatch = _setup(arch)
    assert pb.cfg.remat == "block"
    plain = build_model(get_config(arch).reduce(remat="none"), "cpu")
    out = []
    for bundle in (pb, plain):
        loss, _ = bundle.loss_fn(model, pbatch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def test_loss_fn_takes_no_z_loss_and_serving_takes_no_grad():
    """The reference's loss calls ``cross_entropy(..., z_weight=0.0)``
    whatever ``TrainConfig.z_loss`` says; serving's forward runs under
    ``no_grad`` even on trainable parameters."""
    _, _, pb, model, _, pbatch = _setup("granite_3_2b")
    loss, metrics = pb.loss_fn(model, pbatch)
    assert "z_loss" not in metrics and loss.requires_grad
    assert torch.equal(loss, metrics["nll"])
    logits = pb.forward_fn(model, pbatch)
    assert not logits.requires_grad
    serving = pb.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in serving.parameters())
    trainable = pb.init(torch.Generator().manual_seed(0), trainable=True)
    assert all(p.requires_grad for p in trainable.parameters())
    for a, b in zip(serving.parameters(), trainable.parameters()):
        assert torch.equal(a, b)
