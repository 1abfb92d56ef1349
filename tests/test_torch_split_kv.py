"""The port's split-KV decode against the JAX package on the CPU.

The split-KV step (``models/attention.py`` ``decode_step_split_kv``) runs
on 1, 2 and 4 ``model`` ranks of a (1, n) ("data", "model") gloo mesh, one
process a rank, each holding its stripe of the cache rows:

- the step itself, at the reduced gemma2's window (32) and softcap (50),
  on a bfloat16 cache (bfloat16 q) and an int8 cache (float32 q), at
  cache lengths 17, 33, 50 and 64 of a 64-row cache: row ``cache_len - 1``
  on a stripe boundary for two and four ranks (16, 32), past the window
  (50: the first stripe of four is wholly masked) and the last row. The
  output is held against the JAX package's ``decode_step_split_kv`` run
  jitted under ``set_mesh`` of a (1, n) mesh of forced host devices, and
  against its ordinary decode (the ``attention_step`` arithmetic), at the
  reference's decode band ``atol=3e-4, rtol=1e-3``
  (``tests/test_decode_equivalence.py:36``); the cache stripes, put side
  by side, must equal the reference's updated cache exactly, and only the
  owning rank's stripe may change;
- the reduced gemma2 (local and global layers, softcaps) in float32 with
  its ``compute`` and ``int8`` caches: a prompt's prefill and 12 decode
  steps teacher-forced past the window, through ``decode_step_split_kv``
  (its calls counted: a layer a step) against the mesh-less port's decode
  at the same band;
- ``ServeEngine.serve_queue`` under ``set_mesh`` of a (1, 2) mesh gives the
  greedy tokens of the mesh-less port, and of the JAX engine up to each
  request's first step whose top two logits (the reference's,
  teacher-forced) lie within twice the band of each other: equal tokens
  follow from equal logits only where the margin is wider
  (``tests/test_torch_serve.py`` asserts the margin at every step of its
  requests; here one of 32 steps is a near tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.models.model import default_positions
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt
from torch_ranks import run_jax, run_ranks

ATOL, RTOL = 3e-4, 1e-3
WINDOW, SOFTCAP = 32, 50.0
B, HQ, HKV, D, SMAX = 2, 4, 2, 16, 64
LENGTHS = (17, 33, 50, 64)
KINDS = ("bf16", "int8")
RANKS = (1, 2, 4)
PROMPT, STEPS, CAPACITY = 30, 12, 64
SERVE = dict(requests=4, prompt=40, new=8, slots=2)


def _inputs() -> dict:
    """The step's inputs from a seed, as float32 arrays (bfloat16 values
    where they enter in bfloat16) and the int8 cache with its scales."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)     # noqa: E731
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    k, v = f(B, SMAX, HKV, D), f(B, SMAX, HKV, D)
    out = {"q": f(B, 1, HQ, D) * 4, "k_new": f(B, 1, HKV, D),
           "v_new": f(B, 1, HKV, D)}
    out.update({"bq": bf(out["q"]), "bk_new": bf(out["k_new"]),
                "bv_new": bf(out["v_new"]), "bk": bf(k), "bv": bf(v)})
    for name, x in (("k", k), ("v", v)):
        amax = np.abs(x).max(-1, keepdims=True)
        scale = bf(np.maximum(amax, 1e-6) / 127.0)
        out["i" + name] = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        out["i" + name + "_scale"] = scale
    return out


JAX_STEP = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.jax_compat import set_mesh
from repro.models.attention import (decode_attention, decode_step_split_kv,
                                    dequantize_kv, quantize_kv)
x = dict(np.load(SPEC["inputs"]))
W, CAP = SPEC["window"], SPEC["softcap"]
# one jitted step, the cache length traced: a compile a dtype and mesh
split = jax.jit(lambda q, kn, vn, c, l: decode_step_split_kv(
    q, kn, vn, c, l, window=W, attn_softcap=CAP))
out = {}
for kind in SPEC["kinds"]:
    if kind == "bf16":
        dt = jnp.bfloat16
        q, kn, vn = (jnp.asarray(x[k], dt) for k in ("bq", "bk_new", "bv_new"))
        cache = {"k": jnp.asarray(x["bk"], dt), "v": jnp.asarray(x["bv"], dt)}
    else:
        q, kn, vn = (jnp.asarray(x[k]) for k in ("q", "k_new", "v_new"))
        cache = {"k": jnp.asarray(x["ik"]), "v": jnp.asarray(x["iv"]),
                 "k_scale": jnp.asarray(x["ik_scale"], jnp.bfloat16),
                 "v_scale": jnp.asarray(x["iv_scale"], jnp.bfloat16)}
    for clen in SPEC["lengths"]:
        # the ordinary decode: attention_step's lines without a mesh
        idx = clen - 1
        if kind == "int8":
            (kq, ksc), (vq, vsc) = quantize_kv(kn), quantize_kv(vn)
            upd = lambda a, b: jax.lax.dynamic_update_slice_in_dim(a, b, idx, axis=1)
            kc = dequantize_kv(upd(cache["k"], kq), upd(cache["k_scale"], ksc)).astype(kn.dtype)
            vc = dequantize_kv(upd(cache["v"], vq), upd(cache["v_scale"], vsc)).astype(vn.dtype)
        else:
            kc = jax.lax.dynamic_update_slice_in_dim(cache["k"], kn, idx, axis=1)
            vc = jax.lax.dynamic_update_slice_in_dim(cache["v"], vn, idx, axis=1)
        plain = decode_attention(q, kc, vc, jnp.int32(clen), window=W,
                                 attn_softcap=CAP)
        out[f"plain:{kind}:{clen}"] = np.asarray(plain, np.float32)
        for n in SPEC["ranks"]:
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n),
                        ("data", "model"))
            with set_mesh(mesh):
                o, new = split(q, kn, vn, cache, jnp.int32(clen))
            out[f"split:{kind}:{clen}:{n}"] = np.asarray(o, np.float32)
            for name, arr in new.items():
                out[f"cache:{kind}:{clen}:{n}:{name}"] = np.asarray(
                    arr, np.float32 if arr.dtype == jnp.bfloat16 else arr.dtype)
np.savez(OUT, **out)
"""

RANK_SCRIPT = r"""
import dataclasses
import torch
from repro_torch.compat import set_mesh
from repro_torch.configs import get_config
from repro_torch.launch import make_test_mesh
from repro_torch.models import attention, build_model
from repro_torch.models import transformer as tf
from repro_torch.models.model import default_positions
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt

mesh = make_test_mesh((1, WORLD), ("data", "model"), device="cpu")
x = {k: torch.from_numpy(v) for k, v in np.load(SPEC["inputs"]).items()}
out = {}

# the step itself
for kind in SPEC["kinds"]:
    for clen in SPEC["lengths"]:
        if kind == "bf16":
            q, kn, vn = (x[k].to(torch.bfloat16) for k in ("bq", "bk_new", "bv_new"))
            full = {"k": x["bk"].to(torch.bfloat16), "v": x["bv"].to(torch.bfloat16)}
        else:
            q, kn, vn = x["q"], x["k_new"], x["v_new"]
            full = {"k": x["ik"], "v": x["iv"],
                    "k_scale": x["ik_scale"].to(torch.bfloat16),
                    "v_scale": x["iv_scale"].to(torch.bfloat16)}
        with set_mesh(mesh):
            cache = {k: attention.striped(v, v.shape[1]) for k, v in full.items()}
            before = {k: v.to_local().clone() for k, v in cache.items()}
            assert attention._split_kv_available(cache["k"])
            o, cache = attention.decode_step_split_kv(
                q, kn, vn, cache, clen, window=SPEC["window"],
                attn_softcap=SPEC["softcap"])
        out[f"split:{kind}:{clen}"] = o.float().numpy()
        for k, v in cache.items():
            local = v.to_local()
            out[f"cache:{kind}:{clen}:{k}"] = local.float().numpy() \
                if local.is_floating_point() else local.numpy()
            out[f"changed:{kind}:{clen}:{k}"] = np.array(
                not torch.equal(local, before[k]))

# the reduced gemma2 through the model's decode, split-KV calls counted
calls = [0]
plain_step = attention.decode_step_split_kv
def counted(*a, **kw):
    calls[0] += 1
    return plain_step(*a, **kw)
attention.decode_step_split_kv = counted
seq = torch.from_numpy(np.load(SPEC["inputs"])["tokens"])
for cache_kind in ("compute", "int8"):
    cfg = dataclasses.replace(get_config("gemma2_2b").reduce(),
                              kv_cache_dtype=cache_kind)
    bundle = build_model(cfg, "cpu")
    params, _ = ckpt.load_checkpoint(SPEC["ckpt"], {"params": bundle.skeleton()})
    params = params["params"]
    p, n = SPEC["prompt"], SPEC["steps"]
    calls[0] = 0
    with set_mesh(mesh):
        _, cache = bundle.prefill_fn(params, {"tokens": seq[:, :p]})
        cache = tf.pad_cache_to(cache, cfg, SPEC["capacity"])
        steps = []
        for i in range(n):
            pos = default_positions(cfg, seq.shape[0], 1, offset=p + i)
            logits, cache = bundle.decode_fn(params, seq[:, p + i:p + i + 1],
                                             pos, cache, p + i + 1)
            steps.append(logits[:, 0])
    out[f"model:{cache_kind}"] = torch.stack(steps, 1).numpy()
    out[f"calls:{cache_kind}"] = np.array(calls[0])
    leaf = cache["groups"]["0"][0]["self"]["k"]
    out[f"stripe:{cache_kind}"] = np.array(leaf.to_local().shape[1])

# serve_queue under the mesh
if SPEC["serve"]:
    bundle = build_model(get_config("gemma2_2b").reduce(), "cpu")
    params, _ = ckpt.load_checkpoint(SPEC["ckpt"], {"params": bundle.skeleton()})
    reqs = list(np.load(SPEC["inputs"])["requests"])
    calls[0] = 0
    with set_mesh(mesh):
        got = ServeEngine(bundle, params["params"], ServeConfig(
            max_new_tokens=SPEC["serve"]["new"])).serve_queue(
                reqs, slots=SPEC["serve"]["slots"])
    out["served"] = np.stack(got)
    out["serve_calls"] = np.array(calls[0])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the shared parameters (the JAX package's, saved as a
    port checkpoint), and the JAX package's readings."""
    tmp = tmp_path_factory.mktemp("split_kv")
    rng = np.random.default_rng(1)
    jb = jax_build(jax_config("gemma2_2b").reduce())
    jparams = jb.init(jax.random.key(0))
    pb = build_model(get_config("gemma2_2b").reduce(), "cpu")
    model = params_from_jax(jax.tree.map(np.asarray, jparams), pb.skeleton())
    ckpt.save_checkpoint(tmp / "ckpt", 0, {"params": model})
    vocab = pb.cfg.vocab_size
    inputs = {**_inputs(),
              "tokens": rng.integers(0, vocab, (B, PROMPT + STEPS)).astype(np.int32),
              "requests": rng.integers(0, vocab, (SERVE["requests"], SERVE["prompt"]))
              .astype(np.int32)}
    np.savez(tmp / "inputs.npz", **inputs)
    spec = {"inputs": str(tmp / "inputs.npz"), "ckpt": str(tmp / "ckpt"),
            "kinds": list(KINDS), "lengths": list(LENGTHS),
            "ranks": list(RANKS), "window": WINDOW, "softcap": SOFTCAP,
            "prompt": PROMPT, "steps": STEPS, "capacity": CAPACITY}
    want = run_jax(tmp, max(RANKS), JAX_STEP, spec)
    return {"spec": spec, "jax": want, "inputs": inputs, "jb": jb,
            "jparams": jparams, "pb": pb, "model": model}


def _mesh_less_decode(pb, model, seq, cache_kind):
    cfg = pb.cfg
    bundle = build_model(dataclasses.replace(cfg, kv_cache_dtype=cache_kind),
                         "cpu")
    _, cache = bundle.prefill_fn(model, {"tokens": seq[:, :PROMPT]})
    cache = tf.pad_cache_to(cache, bundle.cfg, CAPACITY)
    steps = []
    for i in range(STEPS):
        pos = default_positions(cfg, seq.shape[0], 1, offset=PROMPT + i)
        logits, cache = bundle.decode_fn(
            model, seq[:, PROMPT + i:PROMPT + i + 1], pos, cache,
            PROMPT + i + 1)
        steps.append(logits[:, 0])
    return torch.stack(steps, 1).numpy()


@pytest.mark.parametrize("n", RANKS)
def test_split_kv_decode_matches_the_reference(tmp_path, setup, n):
    spec = {**setup["spec"],
            "serve": SERVE if n == 2 else None}
    ranks = run_ranks(tmp_path, n, RANK_SCRIPT, spec)
    want = setup["jax"]
    s_loc = SMAX // n
    for kind in KINDS:
        for clen in LENGTHS:
            key = f"{kind}:{clen}"
            owner = (clen - 1) // s_loc
            for r, got in enumerate(ranks):
                out = got["split:" + key]
                np.testing.assert_allclose(out, want[f"split:{key}:{n}"],
                                           atol=ATOL, rtol=RTOL, err_msg=key)
                np.testing.assert_allclose(out, want["plain:" + key],
                                           atol=ATOL, rtol=RTOL, err_msg=key)
                names = ("k", "v", "k_scale", "v_scale") if kind == "int8" \
                    else ("k", "v")
                for name in names:
                    stripe = want[f"cache:{key}:{n}:{name}"][
                        :, r * s_loc:(r + 1) * s_loc]
                    np.testing.assert_array_equal(
                        got[f"cache:{key}:{name}"], stripe, err_msg=key)
                    assert bool(got[f"changed:{key}:{name}"]) == (r == owner), \
                        (key, name, r)
    # the model's decode through the split-KV step, against the mesh-less port
    seq = torch.from_numpy(setup["inputs"]["tokens"])
    layers = setup["pb"].cfg.num_layers
    for cache_kind in ("compute", "int8"):
        plain = _mesh_less_decode(setup["pb"], setup["model"], seq, cache_kind)
        for got in ranks:
            assert int(got["calls:" + cache_kind]) == layers * STEPS
            assert int(got["stripe:" + cache_kind]) == CAPACITY // n
            np.testing.assert_allclose(got["model:" + cache_kind], plain,
                                       atol=ATOL, rtol=RTOL, err_msg=cache_kind)
    if n == 2:
        _check_served(setup, ranks)


def _check_served(setup, ranks):
    jb, jparams, pb, model = (setup[k] for k in ("jb", "jparams", "pb", "model"))
    reqs = list(setup["inputs"]["requests"])
    new, slots = SERVE["new"], SERVE["slots"]
    want = np.stack(JaxServeEngine(jb, jparams, JaxServeConfig(
        max_new_tokens=new)).serve_queue(reqs, slots=slots))
    free = np.stack(ServeEngine(pb, model, ServeConfig(
        max_new_tokens=new)).serve_queue(reqs, slots=slots))
    # equal tokens follow from equal logits only where the top two are
    # further apart than the band: on the reference's teacher-forced
    # logits, each request's tokens are held equal up to its first step
    # whose margin is inside the band (a near tie may pick either)
    seq = np.concatenate([np.stack(reqs), want[:, :-1]], axis=1)
    logits = np.asarray(jb.forward_fn(jparams, {"tokens": jnp.asarray(seq)}))
    steps = logits[:, SERVE["prompt"] - 1:]
    top2 = np.sort(steps, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (ATOL + RTOL * np.abs(top2[..., 1]))
    firm = [int(np.argmin(row)) if not row.all() else new for row in clear]
    assert sum(firm) >= len(firm) * new // 2, firm
    layers = pb.cfg.num_layers
    decode_steps = (SERVE["requests"] // slots) * (new - 1)
    for tokens in [free] + [got["served"] for got in ranks]:
        for j, k in enumerate(firm):
            np.testing.assert_array_equal(tokens[j, :k], want[j, :k])
    for got in ranks:
        np.testing.assert_array_equal(got["served"], free)
        assert int(got["serve_calls"]) == layers * decode_steps
