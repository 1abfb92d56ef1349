"""The port's serving models against the JAX package on the CPU.

Inputs and parameters are made once, with numpy or the JAX package's own
init, and handed to both packages: the port's parameters are the
reference's, through ``params_from_jax``. Layers are held at 1e-6 in
float32; whole-model logits (forward, prefill, teacher-forced decode) at
the reference's own decode band, ``atol=3e-4, rtol=1e-3``
(``tests/test_decode_equivalence.py``). On the CPU the sequence attention,
the SSD mixer and the RG-LRU scan take the plain versions of K4, K5 and
K6. The MoE archs' decode (``B`` tokens a step) and forward (``B·S``)
route with different capacities, so their decode is held to the forward
with the capacity raised until no token drops; at the published one both
are held to the reference.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_tf
from repro.configs import get_config as jax_config
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import layers as jl
from repro.models.model import default_positions as jax_positions
import repro_torch.models.transformer as port_tf
from repro_torch.configs import get_config as port_config
from repro_torch.models import attention as port_attn
from repro_torch.models import build_model, cross_entropy, params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models.model import default_positions as port_positions

DENSE = ["gemma2_2b", "granite_3_2b", "qwen3_8b", "chatglm3_6b", "qwen2_vl_7b"]
# the state-space families: RG-LRU with local attention, and Mamba-2 SSD
STATE = ["recurrentgemma_2b", "mamba2_1_3b"]
# the mixture-of-experts archs (dbrx: 16 experts top 4; arctic: 128 top 2
# with a dense residual), reduced to 4 experts top 2
MOE = ["dbrx_132b", "arctic_480b"]
SERVED = DENSE + STATE + MOE
# the encoder-decoder, whose serving and training tests are
# tests/test_torch_encoder.py's (its batches carry a source)
ENCDEC = ["seamless_m4t_medium"]
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)
DECODE_TOL = dict(atol=3e-4, rtol=1e-3)
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------- layers


def test_rms_norm_and_qk_norm():
    x = RNG.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = RNG.normal(size=(64,)).astype(np.float32) * 0.1
    h = RNG.normal(size=(2, 5, 4, 16)).astype(np.float32)
    gh = RNG.normal(size=(16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        _np(tl.rms_norm(_t(x), _t(g), 1e-6)),
        _np(jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)), **LAYER_TOL)
    np.testing.assert_allclose(
        _np(tl.qk_norm(_t(h), _t(gh), 1e-6)),
        _np(jl.qk_norm(jnp.asarray(h), jnp.asarray(gh), 1e-6)), **LAYER_TOL)


@pytest.mark.parametrize("mode,sections", [("full", ()), ("half", ()),
                                           ("mrope", (4, 2, 2))])
def test_apply_rope(mode, sections):
    x = RNG.normal(size=(2, 7, 4, 16)).astype(np.float32)
    shape = (3, 2, 7) if mode == "mrope" else (2, 7)
    pos = RNG.integers(0, 5000, shape).astype(np.int32)
    got = tl.apply_rope(_t(x), _t(pos), theta=10_000.0, mode=mode,
                        sections=sections)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10_000.0,
                         mode=mode, sections=sections)
    # angles reach 5000 rad: cos/sin of equal float32 angles agree to an ulp
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(act):
    specs = tl.mlp_specs(32, 48, act)
    params = {k: (RNG.normal(size=s.shape) / np.sqrt(s.shape[0])
                  ).astype(np.float32) for k, s in specs.items()}
    x = RNG.normal(size=(2, 5, 32)).astype(np.float32)
    got = tl.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x), act)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x), act)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_lookup_logits_and_softcap(tie):
    specs = tl.embed_specs(50, 32, tie)
    params = {k: (RNG.normal(size=s.shape) * 0.02).astype(np.float32)
              for k, s in specs.items()}
    tok = RNG.integers(0, 50, (2, 6)).astype(np.int32)
    tp = {k: _t(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = tl.embed_lookup(tp, _t(tok), 32)
    np.testing.assert_allclose(
        _np(x), _np(jl.embed_lookup(jp, jnp.asarray(tok), 32)), **LAYER_TOL)
    logits = tl.embed_logits(tp, x)
    want = jl.embed_logits(jp, jnp.asarray(_np(x)))
    np.testing.assert_allclose(_np(logits), _np(want), **LAYER_TOL)
    big = (RNG.normal(size=(3, 40)) * 60).astype(np.float32)
    np.testing.assert_allclose(_np(tl.softcap(_t(big), 30.0)),
                               _np(jl.softcap(jnp.asarray(big), 30.0)),
                               **LAYER_TOL)


def test_spec_trees_match_the_reference():
    for arch in SERVED + ENCDEC:
        port = tl.tree_leaves(port_tf.decoder_specs(port_config(arch)))
        ref = jax.tree_util.tree_flatten_with_path(
            jax_tf.decoder_specs(jax_config(arch)),
            is_leaf=lambda s: isinstance(s, jl.ParamSpec))[0]
        ref = [("/".join(p.key for p in path), s) for path, s in ref]
        assert [(p, s.shape, s.axes, s.init) for p, s in port] == \
            [(p, s.shape, s.axes, s.init) for p, s in ref], arch


def test_init_params_follows_the_reference_rule():
    cfg = port_config("gemma2_2b").reduce()
    gen = torch.Generator().manual_seed(3)
    params = tl.init_params(port_tf.decoder_specs(cfg), gen, torch.float32,
                            "cpu")
    g = params["groups"]["0"]
    assert float(g["ln1"].abs().max()) == 0.0
    np.testing.assert_allclose(float(params["embed"]["table"].std()), 0.02,
                               rtol=0.05)
    # fan_in is the second-last dim: wq (n, d, hq, h) -> 1/sqrt(hq)
    np.testing.assert_allclose(float(g["attn"]["wq"].std()),
                               1 / np.sqrt(cfg.num_heads), rtol=0.05)
    np.testing.assert_allclose(float(g["ffn"]["w_up"].std()),
                               1 / np.sqrt(cfg.d_model), rtol=0.05)
    again = tl.init_params(port_tf.decoder_specs(cfg),
                           torch.Generator().manual_seed(3), torch.float32,
                           "cpu")
    assert torch.equal(g["attn"]["wq"], again["groups"]["0"]["attn"]["wq"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_draws_the_init_rule_into_the_modules(dtype):
    """``bundle.init`` draws leaf by leaf into the skeleton; its tensors
    are those of the tree rule (``init_params`` then ``load_tree``) bit
    for bit, at a reduced gemma2 as at every leaf of the dense and state
    archs, each below ``DRAW_SLICE_ELEMENTS``."""
    from repro_torch.models.convert import load_tree

    cfg = port_config("gemma2_2b").reduce(param_dtype=dtype)
    pb = build_model(cfg, "cpu")
    got = pb.init(torch.Generator().manual_seed(5))
    want = load_tree(pb.skeleton(), tl.init_params(
        pb.specs, torch.Generator().manual_seed(5), getattr(torch, dtype),
        "cpu"))
    for (name, a), (_, b) in zip(got.named_parameters(),
                                 want.named_parameters()):
        assert a.dtype == getattr(torch, dtype)
        assert torch.equal(a, b), name


def test_init_draws_a_large_leaf_a_slice_at_a_time(monkeypatch):
    """A leaf above ``DRAW_SLICE_ELEMENTS`` is drawn one leading-axis slice
    at a time, recursively (a layer, then an expert), in order: the
    experts of a reduced dbrx with the threshold cut to one expert's
    matrix are the consecutive draws of ``(d, F)`` normals."""
    cfg = port_config("dbrx_132b").reduce()
    d, f, e, n = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.group_count
    monkeypatch.setattr(tl, "DRAW_SLICE_ELEMENTS", d * f)
    pb = build_model(cfg, "cpu")
    got = pb.init(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)

    def replay(shape):
        if int(np.prod(shape)) > d * f and len(shape) > 1:
            return torch.stack([replay(shape[1:]) for _ in range(shape[0])])
        return torch.randn(shape, generator=gen)

    for path, spec in tl.spec_leaves(pb.specs):
        if path == "groups/0/ffn/w_gate":
            break
        if spec.init not in ("zeros", "ones"):
            replay(spec.shape)
    std = 1 / np.sqrt(d)
    for g in range(n):
        for x in range(e):
            want = torch.randn((d, f), generator=gen) * std
            assert torch.equal(got.groups["0"][g].ffn.w_gate[x], want)


# --------------------------------------------------------------------------- models


@pytest.fixture(scope="module")
def pair():
    """(reference bundle, reference params, port bundle, port params) per
    arch, made once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_config(arch).reduce()
            jb = jax_build(jcfg)
            params = jb.init(jax.random.key(1))
            pb = build_model(port_config(arch).reduce(), "cpu")
            model = params_from_jax(jax.tree.map(np.asarray, params),
                                    pb.skeleton())
            cache[arch] = (jb, params, pb, model)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", SERVED + ENCDEC)
def test_params_from_jax_consumes_every_leaf(arch, pair):
    jb, params, pb, model = pair(arch)
    leaves = jax.tree.leaves(params)
    assert sum(int(np.prod(x.shape)) for x in leaves) == \
        sum(p.numel() for p in model.parameters())
    cfg = pb.cfg
    # every stacked leaf of pattern position 0's mixer, split layer by layer
    mixer = {"ssd": "ssd", "rec": "rec"}.get(cfg.block_pattern[0], "attn")
    for name, leaf in params["groups"]["0"][mixer].items():
        stacked = np.asarray(leaf)
        for g in range(cfg.group_count):
            np.testing.assert_array_equal(
                model.groups["0"][g][mixer][name].numpy(), stacked[g])
    if cfg.is_moe:
        # the (L, E, D, F) expert leaves, the router and arctic's dense
        # residual, split layer by layer
        ffn = jax.tree_util.tree_flatten_with_path(params["groups"]["0"]["ffn"])[0]
        assert len(ffn) == (7 if cfg.moe_dense_residual else 4)
        for path, leaf in ffn:
            for g in range(cfg.group_count):
                got = model.groups["0"][g]["ffn"]
                for p in path:
                    got = got[p.key]
                np.testing.assert_array_equal(got.numpy(), np.asarray(leaf)[g])
    for i in range(len(cfg.tail_pattern)):
        np.testing.assert_array_equal(
            model.tail[str(i)]["ln1"].numpy(),
            np.asarray(params["tail"][str(i)]["ln1"]))
    if cfg.encoder_layers:
        # the encoder's stacked blocks and each decoder block's cross
        # attention, split layer by layer
        stacks = [(params["encoder"]["blocks"]["attn"],
                   [model.encoder.blocks[g].attn
                    for g in range(cfg.encoder_layers)]),
                  (params["groups"]["0"]["cross"],
                   [model.groups["0"][g].cross
                    for g in range(cfg.group_count)])]
        for leaves, layers in stacks:
            assert set(leaves) == {"wq", "wk", "wv", "wo"}
            for name, leaf in leaves.items():
                for g, layer in enumerate(layers):
                    np.testing.assert_array_equal(layer[name].numpy(),
                                                  np.asarray(leaf)[g])
        np.testing.assert_array_equal(
            model.encoder.final_ln.numpy(),
            np.asarray(params["encoder"]["final_ln"]))
    tree = jax.tree.map(np.asarray, params)
    extra = dict(tree, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="1 leaves with no parameter"):
        params_from_jax(extra, pb.skeleton())
    short = dict(tree)
    del short["final_ln"]
    with pytest.raises(ValueError, match="1 parameters with no leaf"):
        params_from_jax(short, pb.skeleton())


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_and_decode_match_the_reference(arch, pair):
    jb, params, pb, model = pair(arch)
    jcfg, cfg = jb.cfg, pb.cfg
    b = 2
    # gemma2's reduced window is 32: a longer prompt exercises the local mask
    s = cfg.window + 16 if "local_attn" in cfg.block_pattern else 24
    toks = _tokens(cfg, b, s)
    full = jb.forward_fn(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(
        _np(pb.forward_fn(model, {"tokens": _t(toks)})), _np(full),
        **DECODE_TOL)

    steps = 3
    pre = s - steps
    batch = {"tokens": jnp.asarray(toks[:, :pre])}
    port_batch = {"tokens": _t(toks[:, :pre])}
    if cfg.rope_mode == "mrope":
        batch["positions"] = jax_positions(jcfg, b, pre)
        port_batch["positions"] = port_positions(cfg, b, pre)
    jlg, jcache = jb.prefill_fn(params, batch)
    lg, cache = pb.prefill_fn(model, port_batch)
    assert lg.shape == (b, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(jlg), **DECODE_TOL)

    jcache = jax_tf.pad_cache_to(jcache, jcfg, s + 2)
    cache = port_tf.pad_cache_to(cache, cfg, s + 2)
    for i in range(pre, s):          # teacher-forced decode
        jlg, jcache = jb.decode_fn(
            params, jnp.asarray(toks[:, i:i + 1]),
            jax_positions(jcfg, b, 1, offset=i), jcache, jnp.int32(i + 1))
        lg, cache = pb.decode_fn(model, _t(toks[:, i:i + 1]),
                                 port_positions(cfg, b, 1, offset=i), cache,
                                 i + 1)
        np.testing.assert_allclose(_np(lg), _np(jlg), **DECODE_TOL)
        if not cfg.is_moe:
            np.testing.assert_allclose(_np(lg)[:, 0], _np(full)[:, i],
                                       **DECODE_TOL)
    if cfg.is_moe:
        _moe_decode_matches_the_forward_without_drops(pb, model, toks, pre)


def _moe_decode_matches_the_forward_without_drops(pb, model, toks, pre):
    """The teacher-forced decode against the forward pass with the
    capacity at ``E / k`` (one slot an expert for every token, so no
    token drops in either), every routing counted."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(pb.cfg, capacity_factor=pb.cfg.num_experts
                              / pb.cfg.top_k)
    bundle = build_model(cfg, "cpu")
    b, s = toks.shape
    kept = []
    route = moe._route

    def counted(*args):
        r = route(*args)
        kept.append(bool(r.keep.all()))
        return r

    moe._route = counted
    try:
        full = bundle.forward_fn(model, {"tokens": _t(toks)})
        _, cache = bundle.prefill_fn(model, {"tokens": _t(toks[:, :pre])})
        cache = port_tf.pad_cache_to(cache, cfg, s + 2)
        for i in range(pre, s):
            lg, cache = bundle.decode_fn(model, _t(toks[:, i:i + 1]),
                                         port_positions(cfg, b, 1, offset=i),
                                         cache, i + 1)
            np.testing.assert_allclose(_np(lg)[:, 0], _np(full)[:, i],
                                       **DECODE_TOL)
    finally:
        moe._route = route
    assert kept and all(kept)


def test_decode_writes_the_cache_in_place(pair):
    _, _, pb, model = pair("granite_3_2b")
    toks = _tokens(pb.cfg, 1, 9)
    _, cache = pb.prefill_fn(model, {"tokens": _t(toks[:, :8])})
    cache = port_tf.pad_cache_to(cache, pb.cfg, 12)
    k = cache["groups"]["0"][0]["self"]["k"]
    assert float(k[:, 8:].abs().max()) == 0.0
    _, same = pb.decode_fn(model, _t(toks[:, 8:9]),
                           port_positions(pb.cfg, 1, 1, offset=8), cache, 9)
    assert same["groups"]["0"][0]["self"]["k"] is k
    assert float(k[:, 8].abs().max()) > 0 and float(k[:, 9:].abs().max()) == 0


@pytest.mark.parametrize("arch", STATE)
def test_decode_replaces_state_entries_in_the_cache(arch, pair):
    """A state entry (rec, ssd) is new at every step: ``decode_step``
    writes it back into the cache dict it was given, and the next step
    reads it from there."""
    _, _, pb, model = pair(arch)
    cfg = pb.cfg
    toks = _tokens(cfg, 2, 12)
    _, cache = pb.prefill_fn(model, {"tokens": _t(toks[:, :10])})
    cache = port_tf.pad_cache_to(cache, cfg, 14)
    entry = cache["groups"]["0"][0]
    h, conv = entry["h"], entry["conv"]
    lg, same = pb.decode_fn(model, _t(toks[:, 10:11]),
                            port_positions(cfg, 2, 1, offset=10), cache, 11)
    assert same is cache and same["groups"]["0"][0] is entry
    assert entry["h"] is not h and not torch.equal(entry["h"], h)
    np.testing.assert_array_equal(entry["conv"][:, :-1].numpy(),
                                  conv[:, 1:].numpy())
    # the step read the state it was handed: a zeroed state gives others
    _, cache2 = pb.prefill_fn(model, {"tokens": _t(toks[:, :10])})
    cache2 = port_tf.pad_cache_to(cache2, cfg, 14)
    cache2["groups"]["0"][0]["h"].zero_()
    lg2, _ = pb.decode_fn(model, _t(toks[:, 10:11]),
                          port_positions(cfg, 2, 1, offset=10), cache2, 11)
    assert not torch.allclose(lg, lg2, atol=1e-6)


@pytest.mark.parametrize("arch", STATE)
def test_cache_init_and_padding_match_the_reference(arch, pair):
    """Empty caches have the reference's structure, shapes and dtype;
    ``pad_cache_to`` grows the attention entries and passes the state
    entries through unchanged."""
    jb, _, pb, model = pair(arch)
    cfg = pb.cfg
    port = port_tf.cache_init(cfg, 2, 40, torch.bfloat16, "cpu")
    ref = jax_tf.cache_init(jb.cfg, 2, 40, jnp.bfloat16)
    got = [(path, tuple(t.shape), t.dtype) for path, t in tl.tree_leaves(
        {"tail": port["tail"], "groups": {
            i: {str(g): e for g, e in enumerate(entries)}
            for i, entries in port["groups"].items()}})]
    want = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [p.key for p in path]
        if keys[0] == "groups":     # stacked: one entry per repetition
            want += [("/".join([*keys[:2], str(g), *keys[2:]]),
                      leaf.shape[1:], torch.bfloat16)
                     for g in range(leaf.shape[0])]
        else:
            want.append(("/".join(keys), leaf.shape, torch.bfloat16))
    assert sorted(got, key=str) == sorted(want, key=str)
    _, cache = pb.prefill_fn(model, {"tokens": _t(_tokens(cfg, 2, 9))})
    padded = port_tf.pad_cache_to(cache, cfg, 20)
    for i, kind in enumerate(cfg.block_pattern):
        before, after = cache["groups"][str(i)][0], padded["groups"][str(i)][0]
        if kind in ("rec", "ssd"):
            assert after is before
        else:
            assert after["self"]["k"].shape[1] == 20


@pytest.mark.parametrize("z_weight", [0.0, 1e-4])
def test_cross_entropy_matches_the_reference(z_weight):
    logits = (RNG.normal(size=(2, 7, 50)) * 3).astype(np.float32)
    targets = RNG.integers(0, 50, (2, 7)).astype(np.int32)
    targets[0, 0] = logits[0, 0].argmax()           # one certain hit
    loss, metrics = cross_entropy(_t(logits), _t(targets), z_weight)
    jloss, jmetrics = jax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(targets), z_weight)
    np.testing.assert_allclose(float(loss), float(jloss), **LAYER_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for name in metrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), **LAYER_TOL)


# --------------------------------------------------------------------------- int8 KV


def test_quantize_kv_equals_the_reference():
    x = (RNG.normal(size=(2, 16, 4, 32)) * 5.0).astype(np.float32)
    x[0, 0, 0] = 0.0                             # an all-zero row: scale floor
    q, s = port_attn.quantize_kv(_t(x))
    jq, js = jax_attn.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.to(torch.float32).numpy(),
                                  np.asarray(js, np.float32))
    np.testing.assert_array_equal(
        port_attn.dequantize_kv(q, s).numpy(),
        np.asarray(jax_attn.dequantize_kv(jq, js)))


@pytest.mark.parametrize("arch", ["granite_3_2b", "gemma2_2b"])
def test_int8_decode_close_to_full_precision(arch):
    """The reference's int8 test (tests/test_kv_int8.py) on the port, with
    its bands: int8 entries in the cache, and the decode logits within 10 %
    of the full-precision forward's scale."""
    jcfg = jax_config(arch).reduce(kv_cache_dtype="int8", head_dim=64)
    params = jax_build(jcfg).init(jax.random.key(0))
    cfg = port_config(arch).reduce(kv_cache_dtype="int8", head_dim=64)
    pb = build_model(cfg, "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params), pb.skeleton())
    b, s = 2, 20
    toks = _tokens(cfg, b, s)
    full = pb.forward_fn(model, {"tokens": _t(toks)})
    _, cache = pb.prefill_fn(model, {"tokens": _t(toks[:, :s - 1])})
    entry = cache["groups"]["0"][0]["self"]
    assert entry["k"].dtype == torch.int8 and entry["k_scale"].dtype == \
        torch.bfloat16
    cache = port_tf.pad_cache_to(cache, cfg, s + 4)
    lg, _ = pb.decode_fn(model, _t(toks[:, s - 1:s]),
                         port_positions(cfg, b, 1, offset=s - 1), cache, s)
    err = float((lg[:, 0] - full[:, s - 1]).abs().max())
    scale = float(full[:, s - 1].abs().max())
    assert err / max(scale, 0.1) < 0.10, (err, scale)
    agree = float((lg[:, 0].argmax(-1) == full[:, s - 1].argmax(-1))
                  .float().mean())
    assert agree >= 0.5, agree


# --------------------------------------------------------------------------- devices


def test_build_model_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(port_config("gemma2_2b").reduce())


@pytest.mark.parametrize("arch", STATE + MOE + ENCDEC)
def test_state_archs_need_cuda_unless_told_cpu(arch):
    """At full width, as a user builds them: the card by default."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(port_config(arch))
    assert build_model(port_config(arch).reduce(), "cpu").device.type == "cpu"
