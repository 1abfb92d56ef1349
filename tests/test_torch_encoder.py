"""The port's encoder-decoder (seamless) against the JAX package on the
CPU: the encoder, cross attention and their caches.

The reduced seamless (2 encoder and 2 decoder layers, d 64, 4 query heads
over 2 key/value heads) is built in both packages with the reference's
parameters, carried into the port by ``params_from_jax``; the sources are
numpy draws of 12 and 16 frames (``tests/test_decode_equivalence.py:27-29``
and ``tests/test_models_smoke.py:23-26``). The encoder, the forward
logits, prefill's last logits and the teacher-forced decode step after
``pad_cache_to`` are held at the reference's decode band (``atol=3e-4,
rtol=1e-3``); greedy tokens of ``generate(prompts, src_embeds)`` equal
the reference engine's; ``loss_fn`` at 1e-5 and every gradient, encoder
and cross leaves included, within 1e-3 in relative L2 of ``jax.grad``
under ``remat="block"`` and ``"none"`` (the reading is about 8.5e-4 at
the first cross norm: the seeded attention is near one-hot, and a source
moved by one float32 ulp moves the port's own gradients by 1.2e-3); one
``make_train_step`` with two microbatches as in
``tests/test_torch_train.py``, the first moment and the update held to the
gradients' 1e-3 (they read 4e-4 at the tied embedding) and each element
within two learning rates (Adam's first step takes a gradient near zero
to a full step of either sign). On the CPU the
attention takes K4's and K4b's plain versions (``attention_bhsd_ref``,
``attention_bwd_ref``), which the recorder of the last test watches: every
non-causal call on this path gives every query row a live key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_tf
from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.models.model import default_positions as jax_positions
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import optimizer as jopt
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
import repro_torch.models.transformer as port_tf
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.model import default_positions as port_positions
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import make_train_step
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import reference_layout
from repro_torch.train.train_step import TrainState

ARCH = "seamless_m4t_medium"
SOURCES = [12, 16]
DECODE_TOL = dict(atol=3e-4, rtol=1e-3)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(tree) -> dict:
    return {k: (torch.stack(ts) if st else ts[0]).detach().numpy()
            for k, (ts, st) in reference_layout(tree).items()}


@pytest.fixture(scope="module")
def pair():
    """(reference bundle, reference params, port bundle, port model),
    reduced seamless, made once."""
    jb = jax_build(jax_config(ARCH).reduce())
    params = jb.init(jax.random.key(1))
    pb = build_model(get_config(ARCH).reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params), pb.skeleton())
    return jb, params, pb, model


def _batch(cfg, b, s, s_enc, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "src_embeds": rng.normal(size=(b, s_enc, cfg.d_model)
                                 ).astype(np.float32),
    }


def _both(batch, keys=("tokens", "src_embeds")):
    return ({k: jnp.asarray(batch[k]) for k in keys},
            {k: _t(batch[k]) for k in keys})


# --------------------------------------------------------------------------- forward


@pytest.mark.parametrize("s_enc", SOURCES)
def test_encoder_apply_matches_the_reference(pair, s_enc):
    jb, params, pb, model = pair
    src = _batch(pb.cfg, 2, 8, s_enc)["src_embeds"]
    want = jax_tf.encoder_apply(params["encoder"], jnp.asarray(src), jb.cfg,
                                None)
    with torch.no_grad():
        got = port_tf.encoder_apply(model.encoder, _t(src), pb.cfg)
    assert got.shape == (2, s_enc, pb.cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL)


@pytest.mark.parametrize("s_enc", SOURCES)
def test_forward_prefill_and_decode_match_the_reference(pair, s_enc):
    jb, params, pb, model = pair
    jcfg, cfg = jb.cfg, pb.cfg
    b, s, steps = 2, 24, 3
    batch = _batch(cfg, b, s, s_enc)
    jbatch, pbatch = _both(batch)
    full = jb.forward_fn(params, jbatch)
    got = pb.forward_fn(model, pbatch)
    np.testing.assert_allclose(_np(got), _np(full), **DECODE_TOL)

    pre = s - steps
    jlg, jcache = jb.prefill_fn(params, dict(
        jbatch, tokens=jbatch["tokens"][:, :pre]))
    lg, cache = pb.prefill_fn(model, dict(pbatch,
                                          tokens=pbatch["tokens"][:, :pre]))
    assert lg.shape == (b, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(jlg), **DECODE_TOL)

    jcache = jax_tf.pad_cache_to(jcache, jcfg, s + 2)
    cache = port_tf.pad_cache_to(cache, cfg, s + 2)
    toks = batch["tokens"]
    for i in range(pre, s):          # teacher-forced decode
        jlg, jcache = jb.decode_fn(
            params, jnp.asarray(toks[:, i:i + 1]),
            jax_positions(jcfg, b, 1, offset=i), jcache, jnp.int32(i + 1))
        lg, cache = pb.decode_fn(model, _t(toks[:, i:i + 1]),
                                 port_positions(cfg, b, 1, offset=i), cache,
                                 i + 1)
        np.testing.assert_allclose(_np(lg), _np(jlg), **DECODE_TOL)
        np.testing.assert_allclose(_np(lg)[:, 0], _np(full)[:, i],
                                   **DECODE_TOL)


def test_a_batch_without_a_source_raises_as_the_reference(pair):
    jb, params, pb, model = pair
    toks = _batch(pb.cfg, 1, 8, 12)["tokens"]
    with pytest.raises(KeyError, match="src_embeds"):
        jb.forward_fn(params, {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="src_embeds"):
        pb.forward_fn(model, {"tokens": _t(toks)})


# --------------------------------------------------------------------------- caches


def _entries(cache):
    for section in cache.values():
        for e in section.values():
            yield from (e if isinstance(e, list) else [e])


@pytest.mark.parametrize("kv_cache_dtype", ["compute", "int8"])
def test_cache_structure_and_cross_entries(pair, kv_cache_dtype):
    """Prefill's cache has the structure of ``cache_init(..., cross_len)``
    (the reference's keys, its stacked axis split into a list); every
    attention entry holds ``cross`` of (B, cross_len, Hkv, D) in the
    compute dtype, uncast under an int8 KV cache, which
    ``pad_cache_to`` leaves as it is while it grows ``self``; and the
    decode step reads it without writing it."""
    jb, params, _, model = pair
    cfg = dataclasses.replace(get_config(ARCH).reduce(),
                              kv_cache_dtype=kv_cache_dtype)
    pb = build_model(cfg, "cpu")
    b, s, s_enc = 2, 10, 12
    batch = _batch(cfg, b, s, s_enc)
    _, pbatch = _both(batch)
    _, cache = pb.prefill_fn(model, pbatch)
    empty = pb.cache_init(b, s + 4, cross_len=s_enc)
    jempty = jax_tf.cache_init(dataclasses.replace(
        jb.cfg, kv_cache_dtype=kv_cache_dtype), b, s + 4, jnp.float32, s_enc)
    assert set(jempty["groups"]["0"]) == set(empty["groups"]["0"][0]) == \
        set(cache["groups"]["0"][0]) == {"self", "cross"}
    for name in ("self", "cross"):
        assert set(jempty["groups"]["0"][name]) == \
            set(empty["groups"]["0"][0][name]) == \
            set(cache["groups"]["0"][0][name])
    shape = (b, s_enc, cfg.num_kv_heads, cfg.resolved_head_dim)
    self_dtype = torch.int8 if kv_cache_dtype == "int8" else torch.float32
    grown = port_tf.pad_cache_to(cache, cfg, s + 4)
    entries = list(_entries(grown))
    assert len(entries) == cfg.num_layers
    for e, e0, before in zip(entries, _entries(empty), _entries(cache)):
        for x in (e, e0):
            assert x["self"]["k"].dtype == self_dtype
            assert x["self"]["k"].shape[1] == s + 4
            for name in ("k", "v"):
                assert x["cross"][name].shape == shape
                assert x["cross"][name].dtype == torch.float32
        assert e["cross"] is before["cross"]
    kept = [t.clone() for e in entries for t in e["cross"].values()]
    pb.decode_fn(model, _t(batch["tokens"][:, :1]),
                 port_positions(cfg, b, 1, offset=s), grown, s + 1)
    after = [t for e in _entries(grown) for t in e["cross"].values()]
    assert all(torch.equal(a, k) for a, k in zip(after, kept))


# --------------------------------------------------------------------------- serving


def test_generate_greedy_tokens_match_the_reference_engine(pair):
    jb, params, pb, model = pair
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, pb.cfg.vocab_size, (3, 10)).astype(np.int32)
    src = rng.normal(size=(3, 16, pb.cfg.d_model)).astype(np.float32)
    want = JaxServeEngine(jb, params, JaxServeConfig(
        max_new_tokens=6)).generate(prompts, src)
    engine = ServeEngine(pb, model, ServeConfig(max_new_tokens=6))
    got = engine.generate(prompts, src)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        engine.generate(prompts, torch.from_numpy(src), max_new_tokens=4),
        want[:, :4])
    with pytest.raises(KeyError, match="src_embeds"):
        engine.serve_queue(list(prompts), slots=2)


# --------------------------------------------------------------------------- training


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_gradients_match_the_reference(pair, remat):
    jb, params, _, _ = pair
    pb = build_model(get_config(ARCH).reduce(remat=remat), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            pb.skeleton(trainable=True))
    batch = _batch(pb.cfg, 2, 24, 16)
    keys = ("tokens", "targets", "src_embeds")
    jbatch, pbatch = _both(batch, keys)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(params, jbatch)
    loss, metrics = pb.loss_fn(model, pbatch)
    assert set(metrics) == set(jm)
    for k in metrics:
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jm[k]),
                                   **LOSS_TOL, err_msg=k)
    names, leaves = zip(*model.named_parameters())
    got = _stacked(dict(zip(names, torch.autograd.grad(loss, leaves))))
    want = _jax_flat(jgrads)
    assert set(got) == set(want)
    assert any(k.startswith("encoder/blocks/") for k in want)
    assert any("/cross/" in k for k in want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel_l2(got[k], want[k]) < GRAD_REL_L2, k
        if k.startswith("encoder/blocks/") and not k.endswith(("ln1", "ln2")):
            assert np.abs(got[k]).max() > 0, k


def test_remat_changes_no_bit(pair):
    """The encoder's layers and the decoder's groups under checkpoints
    (the memory an input of each decoder checkpoint): the loss and every
    gradient equal ``remat="none"``'s, bit for bit."""
    _, params, pb, _ = pair
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            pb.skeleton(trainable=True))
    batch = _batch(pb.cfg, 2, 16, 12)
    _, pbatch = _both(batch, ("tokens", "targets", "src_embeds"))
    plain = build_model(get_config(ARCH).reduce(remat="none"), "cpu")
    out = []
    for bundle in (pb, plain):
        loss, _ = bundle.loss_fn(model, pbatch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def test_train_step_with_microbatches_matches_the_reference(pair):
    """One step with the batch in two microbatches, ``src_embeds`` sliced
    beside the tokens (``train/train_step.py:56``)."""
    jb, params, pb, _ = pair
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20,
              microbatches=2)
    batch = _batch(pb.cfg, 4, 16, 12, seed=3)
    jstate = JaxTrainState(params, jopt.adamw_init(params,
                                                   JaxTrainConfig(**kw)))
    jstate, jm = jax.jit(jax_make_train_step(jb, JaxTrainConfig(**kw)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = TrainConfig(**kw)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            pb.skeleton(trainable=True))
    state = TrainState(model, opt.adamw_init(model, tcfg))
    state, m = make_train_step(pb, tcfg)(
        state, {k: _t(v) for k, v in batch.items()})
    assert set(m) == set(jm)
    for k in ("loss", "nll", "accuracy", "lr"):
        np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(_np(m["grad_norm"]),
                               np.asarray(jm["grad_norm"]), rtol=1e-4)
    before = _jax_flat(params)
    got, want = _stacked(state.params), _jax_flat(jstate.params)
    mu, jmu = _stacked(state.opt.mu), _jax_flat(jstate.opt.mu)
    assert set(got) == set(want) == set(mu) == set(jmu)
    lr = float(jm["lr"])
    for k in want:
        assert _rel_l2(mu[k], jmu[k]) < GRAD_REL_L2, k
        firm = np.abs(jmu[k]) > (1 - 0.9) * 1e-6      # mu = (1 - b1) g
        assert _rel_l2((got[k] - before[k])[firm],
                       (want[k] - before[k])[firm]) < GRAD_REL_L2, k
        # Adam's first step moves each element by lr g / (|g| + eps): an
        # element whose gradient lies within the two packages' difference
        # of zero may step the other way, 2 lr apart
        np.testing.assert_allclose(got[k], want[k], atol=2 * lr, rtol=0,
                                   err_msg=k)


# --------------------------------------------------------------------------- masks


def test_every_non_causal_row_has_a_live_key(pair, monkeypatch):
    """Every attention call of this path, forward (prefill, loss) and
    backward, records its masks: the non-causal ones (the encoder's self
    attention, ``Sq = Skv``, and the cross attention, ``Sq != Skv``) have
    no window, and every query row keeps a live key, so a row with none
    (where K4b's plain version and the reference's scan disagree) never
    arises here. The causal calls are the decoder's self attention."""
    _, params, pb, model = pair
    trainable = params_from_jax(jax.tree.map(np.asarray, params),
                                pb.skeleton(trainable=True))
    calls = []

    def live_rows(q, k, kw):
        mask = attn_ref._mask(q.shape[2], k.shape[2], causal=kw["causal"],
                              window=kw["window"], q_offset=0,
                              skv_valid=k.shape[2], device=q.device)
        calls.append((kw["causal"], kw["window"], q.shape[2], k.shape[2],
                      bool(mask.any(dim=-1).all())))

    fwd, bwd = attn_ops.attention_bhsd_ref, attn_ops.attention_bwd_ref

    def fwd_recorded(q, k, v, **kw):
        live_rows(q, k, kw)
        return fwd(q, k, v, **kw)

    def bwd_recorded(q, k, v, out, dout, lse, **kw):
        live_rows(q, k, kw)
        return bwd(q, k, v, out, dout, lse, **kw)

    monkeypatch.setattr(attn_ops, "attention_bhsd_ref", fwd_recorded)
    monkeypatch.setattr(attn_ops, "attention_bwd_ref", bwd_recorded)
    s, s_enc = 24, 16
    batch = _batch(pb.cfg, 2, s, s_enc)
    _, pbatch = _both(batch, ("tokens", "targets", "src_embeds"))
    pb.prefill_fn(model, pbatch)
    loss, _ = pb.loss_fn(trainable, pbatch)
    loss.backward()
    cfg = pb.cfg
    # prefill; the loss's forward, its recomputation under remat and its
    # backward
    passes = 4
    assert len(calls) == passes * (cfg.encoder_layers + 2 * cfg.num_layers)
    encoder = [c for c in calls if not c[0] and c[2] == c[3] == s_enc]
    cross = [c for c in calls if not c[0] and (c[2], c[3]) == (s, s_enc)]
    causal = [c for c in calls if c[0]]
    assert len(encoder) == passes * cfg.encoder_layers
    assert len(cross) == len(causal) == passes * cfg.num_layers
    assert all(window == 0 for c, window, *_ in calls if not c)
    assert all(live for *_, live in calls)
