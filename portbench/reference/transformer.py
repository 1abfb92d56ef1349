"""Plain PyTorch reference of the transformer configurations the
benchmark runs: decoder-only stacks of attention blocks with a dense or a
mixture-of-experts FFN (dbrx_132b), and encoder-decoders (seamless_m4t_medium).

It imports nothing of the program. It is written from the semantics the
configuration file states, in float32 with TF32 off, op by op with no
kernel, cache or batching of its own:

- embeddings ``table[token] * sqrt(d_model)``; RMS norms
  ``x / rms(x) * (1 + gamma)`` (gamma stored as the offset from 1);
- rotary embeddings on the two halves of each head, angles in float64;
- grouped-query attention, query head ``h`` reading key/value head
  ``h // (Hq / Hkv)``, scores ``q.k / sqrt(d)``, causal in the decoder,
  bidirectional in the encoder and in cross attention (which takes no
  rotary embedding);
- the MoE FFN: a float32 router, the ``top_k`` experts of each token by a
  stable descending sort, their gates renormalised over the ``top_k``,
  each (token, slot) pair's rank within its expert counted in token-major
  order, the pairs at or past ``ceil(capacity_factor * top_k * T / E)``
  dropped (``T`` the tokens of one call: a batch's whole prefill, or one
  decode step's batch), and each kept pair's expert output added with its
  gate;
- a SwiGLU or tanh-GELU FFN; logits from the final norm through the head
  (or the tied table).

Weights come from a ``source(name) -> tensor`` that the caller gives: the
same values the program was handed, in the stored dtype, which the
reference reads as float32. Parameter names follow the module tree the
configuration lays out (``groups.0.<layer>.attn.wq``,
``encoder.blocks.<layer>.ffn.w_up``, ...): :func:`parameter_shapes` lists
them.

``precision="fp8"`` is the control: every matrix product of the model
(projections, expert and FFN products, the head) and attention's q, k and
v take float8 e4m3 operands (a scale a row of activations, a scale an
output column of weights), and in training the products' output
gradients are rounded to float8 e5m2 (a scale a row) for the backward
products, as fp8 training does; the rest as above. The router stays
float32, as the configuration states it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0

#: what this reference implements of a configuration; anything else raises
SUPPORTED_BLOCKS = ("attn",)


def check_supported(cfg: dict) -> None:
    """Raise ``NotImplementedError`` for a configuration feature this
    reference does not state."""
    bad = []
    if tuple(cfg.get("block_pattern", ("attn",))) != SUPPORTED_BLOCKS:
        bad.append(f"block_pattern {cfg['block_pattern']}")
    for key in ("attn_logit_softcap", "final_logit_softcap"):
        if cfg.get(key, 0.0):
            bad.append(key)
    if cfg.get("qk_norm"):
        bad.append("qk_norm")
    if cfg.get("rope_mode", "full") != "full":
        bad.append(f"rope_mode {cfg['rope_mode']}")
    if cfg.get("moe_dense_residual"):
        bad.append("moe_dense_residual")
    if cfg.get("kv_cache_dtype", "compute") != "compute":
        bad.append("kv_cache_dtype")
    if bad:
        raise NotImplementedError(f"reference: {', '.join(bad)}")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


# --------------------------------------------------------------------------- layout


def _attn_shapes(cfg: dict) -> dict:
    d, h = cfg["d_model"], head_dim(cfg)
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    return {"wq": (d, hq, h), "wk": (d, hkv, h), "wv": (d, hkv, h),
            "wo": (hq, h, d)}


def _ffn_shapes(cfg: dict, moe: bool) -> dict:
    d, f = cfg["d_model"], cfg["d_ff"]
    gated = cfg["act"] in ("swiglu", "geglu")
    if moe:
        e = cfg["num_experts"]
        return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
                "w_down": (e, f, d)}
    out = {"w_up": (d, f), "w_down": (f, d)}
    if gated:
        out["w_gate"] = (d, f)
    return out


def _block_shapes(cfg: dict, prefix: str, moe: bool, cross: bool) -> dict:
    d = cfg["d_model"]
    out = {f"{prefix}ln1": (d,), f"{prefix}ln2": (d,)}
    out.update({f"{prefix}attn.{k}": s for k, s in _attn_shapes(cfg).items()})
    out.update({f"{prefix}ffn.{k}": s
                for k, s in _ffn_shapes(cfg, moe).items()})
    if cross:
        out[f"{prefix}ln_cross"] = (d,)
        out.update({f"{prefix}cross.{k}": s
                    for k, s in _attn_shapes(cfg).items()})
    return out


def decoder_prefix(layer: int) -> str:
    return f"groups.0.{layer}."


def encoder_prefix(layer: int) -> str:
    return f"encoder.blocks.{layer}."


def parameter_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the configuration, by name, with its shape."""
    check_supported(cfg)
    d, v = cfg["d_model"], cfg["vocab_size"]
    moe = cfg.get("num_experts", 0) > 0
    enc = cfg.get("encoder_layers", 0)
    out = {"embed.table": (v, d), "final_ln": (d,)}
    if not cfg.get("tie_embeddings", True):
        out["embed.head"] = (d, v)
    for g in range(cfg["num_layers"]):
        out.update(_block_shapes(cfg, decoder_prefix(g), moe, enc > 0))
    for layer in range(enc):
        out.update(_block_shapes(cfg, encoder_prefix(layer), False, False))
    if enc:
        out["encoder.final_ln"] = (d,)
    return out


# --------------------------------------------------------------------------- arithmetic


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matrix products and convolutions while the reference
    runs; the previous settings restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim: int,
              dtype: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 type with one scale along ``dim`` (the
    largest magnitude maps to the type's largest), back in float32. The
    gradient passes through unchanged."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / top
    q = (x.detach() / scale).to(dtype).to(torch.float32) * scale
    return x + (q - x).detach()


class Fp8Matmul(torch.autograd.Function):
    """``x @ w`` as fp8 training computes it: e4m3 operands forward (a
    scale a row of ``x``, a scale a column of ``w``), and the output's
    gradient in e5m2 (a scale a row) for both backward products."""

    @staticmethod
    def forward(ctx, x, w):
        xq = fp8_round(x.detach(), -1)
        wq = fp8_round(w.detach(), 0)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, -1, torch.float8_e5m2)
        dx = gq @ wq.T
        dw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return dx, dw


class Arith:
    """The reference's matrix products: float32, or the fp8 control."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    @property
    def fp8(self) -> bool:
        return self.precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w``, ``w`` (K, N) a weight (a scale an output column)."""
        if not self.fp8:
            return x @ w
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return Fp8Matmul.apply(x, w)
        return fp8_round(x, -1) @ fp8_round(w, 0)


# --------------------------------------------------------------------------- layers


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + gamma)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, H, D) at ``positions`` (S,): the
    first and second halves of each head rotated as pairs."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                         device=x.device) / half)
    ang = positions.to(torch.float64)[:, None] * freqs
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           arith: Arith) -> torch.Tensor:
    """Softmax attention: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D); the
    causal mask aligns the last query with the last key."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if arith.fp8:
        q, k, v = (fp8_round(t, -1) for t in (q, k, v))
    qg = q.reshape(b, sq, hkv, g, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, sq, hq, d)


def _heads(x: torch.Tensor, w: torch.Tensor, arith: Arith) -> torch.Tensor:
    d, h, k = w.shape
    return arith.mm(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def attention(w: Callable[[str], torch.Tensor], prefix: str, x: torch.Tensor,
              cfg: dict, arith: Arith, *, causal: bool,
              positions: Optional[torch.Tensor],
              memory: Optional[torch.Tensor] = None,
              rows: bool = False) -> torch.Tensor:
    """One attention sublayer (self attention, or cross attention to
    ``memory``), its output projected back to (B, S, d_model). ``rows``
    computes batch row by batch row (no gradient needed: less memory)."""
    src = x if memory is None else memory
    q = _heads(x, w(prefix + "wq"), arith)
    k = _heads(src, w(prefix + "wk"), arith)
    v = _heads(src, w(prefix + "wv"), arith)
    if positions is not None:
        q = rope(q, positions, cfg["rope_theta"])
        k = rope(k, positions, cfg["rope_theta"])
    if rows:
        ctx = torch.cat([attend(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal,
                                arith) for i in range(q.shape[0])])
    else:
        ctx = attend(q, k, v, causal, arith)
    wo = w(prefix + "wo")
    hq, h, d = wo.shape
    return arith.mm(ctx.flatten(-2), wo.reshape(hq * h, d))


def dense_ffn(w: Callable[[str], torch.Tensor], prefix: str, x: torch.Tensor,
              act: str, arith: Arith) -> torch.Tensor:
    up = arith.mm(x, w(prefix + "w_up"))
    if act == "swiglu":
        up = F.silu(arith.mm(x, w(prefix + "w_gate"))) * up
    elif act == "geglu":
        up = F.gelu(arith.mm(x, w(prefix + "w_gate")),
                    approximate="tanh") * up
    elif act == "gelu":
        up = F.gelu(up, approximate="tanh")
    else:
        raise NotImplementedError(f"act {act!r}")
    return arith.mm(up, w(prefix + "w_down"))


def capacity(tokens: int, cfg: dict) -> int:
    return max(math.ceil(cfg["capacity_factor"] * cfg["top_k"] * tokens
                         / cfg["num_experts"]), 1)


def route(x2d: torch.Tensor, router: torch.Tensor, cfg: dict):
    """One call's routing: ``(token, gate, expert)`` of every kept
    (token, slot) pair, in token-major order."""
    e, k = cfg["num_experts"], cfg["top_k"]
    t = x2d.shape[0]
    probs = torch.softmax(x2d @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    ids = idx[:, :k].reshape(-1)
    rank = F.one_hot(ids, e).cumsum(0).gather(1, ids[:, None])[:, 0] - 1
    keep = rank < capacity(t, cfg)
    tok = torch.arange(t, device=x2d.device).repeat_interleave(k)
    return tok[keep], gates.reshape(-1)[keep], ids[keep]


def moe_calls(w: Callable[[str], torch.Tensor], prefix: str,
              calls: list[torch.Tensor], cfg: dict, arith: Arith
              ) -> list[torch.Tensor]:
    """The MoE FFN over each call's tokens ``(T_i, d)``, each routed with
    its own capacity; the experts run one at a time over the pairs of
    every call."""
    router = w(prefix + "router")
    offsets, rows, gates, ids = 0, [], [], []
    for x2d in calls:
        tok, gate, ex = route(x2d, router, cfg)
        rows.append(tok + offsets)
        gates.append(gate)
        ids.append(ex)
        offsets += x2d.shape[0]
    x = torch.cat(calls)
    rows, gates, ids = torch.cat(rows), torch.cat(gates), torch.cat(ids)
    out = torch.zeros_like(x)
    gated = cfg["act"] in ("swiglu", "geglu")
    for e in range(cfg["num_experts"]):
        sel = ids == e
        if not bool(sel.any()):
            continue
        r = rows[sel]
        h = x[r]
        up = arith.mm(h, w(prefix + "w_up")[e])
        if gated:
            gate = arith.mm(h, w(prefix + "w_gate")[e])
            gate = (F.silu(gate) if cfg["act"] == "swiglu"
                    else F.gelu(gate, approximate="tanh"))
            up = gate * up
        else:
            up = F.gelu(up, approximate="tanh")
        y = arith.mm(up, w(prefix + "w_down")[e]) * gates[sel][:, None]
        # a token meets each expert at most once in a call: no index repeats
        out = out.index_put((r,), out[r] + y)
    return list(out.split([c.shape[0] for c in calls]))


def embed(w: Callable[[str], torch.Tensor], tokens: torch.Tensor, cfg: dict
          ) -> torch.Tensor:
    return w("embed.table")[tokens] * math.sqrt(cfg["d_model"])


def logits(w: Callable[[str], torch.Tensor], x: torch.Tensor, cfg: dict,
           arith: Arith) -> torch.Tensor:
    x = rms_norm(x, w("final_ln"), cfg["norm_eps"])
    if cfg.get("tie_embeddings", True):
        return arith.mm(x, w("embed.table").T)
    return arith.mm(x, w("embed.head"))


def encoder(w: Callable[[str], torch.Tensor], src: torch.Tensor, cfg: dict,
            arith: Arith) -> torch.Tensor:
    """The bidirectional encoder over the source's frame embeddings."""
    eps = cfg["norm_eps"]
    pos = torch.arange(src.shape[1], device=src.device)
    x = src
    for layer in range(cfg["encoder_layers"]):
        p = encoder_prefix(layer)
        x = x + attention(w, p + "attn.", rms_norm(x, w(p + "ln1"), eps),
                          cfg, arith, causal=False, positions=pos)
        x = x + dense_ffn(w, p + "ffn.", rms_norm(x, w(p + "ln2"), eps),
                          cfg["act"], arith)
    return rms_norm(x, w("encoder.final_ln"), eps)


def decoder_forward(w: Callable[[str], torch.Tensor], tokens: torch.Tensor,
                    cfg: dict, arith: Arith,
                    memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, S, V) of a dense-FFN decoder over whole sequences (the
    training forward; an MoE decoder's training is not stated here)."""
    if cfg.get("num_experts", 0):
        raise NotImplementedError("reference: MoE training")
    eps = cfg["norm_eps"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(w, tokens, cfg)
    for g in range(cfg["num_layers"]):
        p = decoder_prefix(g)
        x = x + attention(w, p + "attn.", rms_norm(x, w(p + "ln1"), eps),
                          cfg, arith, causal=True, positions=pos)
        if memory is not None:
            x = x + attention(w, p + "cross.",
                              rms_norm(x, w(p + "ln_cross"), eps), cfg,
                              arith, causal=False, positions=None,
                              memory=memory)
        x = x + dense_ffn(w, p + "ffn.", rms_norm(x, w(p + "ln2"), eps),
                          cfg["act"], arith)
    return logits(w, x, cfg, arith)


def loss(w: Callable[[str], torch.Tensor], batch: dict, cfg: dict,
         arith: Arith) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``batch["targets"]``."""
    memory = None
    if cfg.get("encoder_layers", 0):
        memory = encoder(w, batch["src_embeds"].to(torch.float32), cfg, arith)
    out = decoder_forward(w, batch["tokens"], cfg, arith, memory)
    return F.cross_entropy(out.flatten(0, 1), batch["targets"].reshape(-1)
                           .long())


# --------------------------------------------------------------------------- serving


def served_logits(source: Callable[[str], torch.Tensor], cfg: dict,
                  batches: list[tuple[torch.Tensor, torch.Tensor]],
                  precisions: tuple[str, ...] = ("float32",)
                  ) -> dict[str, list[torch.Tensor]]:
    """The logits a served decoder-only model must give, teacher-forced.

    ``batches``: ``(prompts (B, S), served (B, N))`` of each batch the
    program served together, the served tokens its own. Returns, for each
    precision, one ``(B, N, V)`` float32 tensor a batch: the logits from
    which token ``i`` of each request was chosen (the prompt's last
    position for ``i = 0``, the step that read served token ``i - 1``
    after). The prompt of a batch is one MoE call (all ``B x S`` tokens),
    and each decode step's ``B`` tokens are one call, as they are served.
    The stack runs layer by layer over every batch, so that each layer's
    weights are read once, as float32, and freed before the next."""
    check_supported(cfg)
    if cfg.get("encoder_layers", 0):
        raise NotImplementedError("reference: serving an encoder-decoder")
    eps = cfg["norm_eps"]
    cache: dict = {}

    def w(name: str) -> torch.Tensor:
        if name not in cache:
            cache[name] = source(name).to(torch.float32)
        return cache[name]

    moe = cfg.get("num_experts", 0) > 0
    out: dict[str, list[torch.Tensor]] = {}
    with strict_float32(), torch.no_grad():
        streams = {}
        for prec in precisions:
            streams[prec] = [embed(w, torch.cat([p, s[:, :-1]], dim=1), cfg)
                             for p, s in batches]
        for g in range(cfg["num_layers"]):
            cache.clear()
            p = decoder_prefix(g)
            for prec, xs in streams.items():
                arith = Arith(prec)
                for j, (prompts, served) in enumerate(batches):
                    x = xs[j]
                    pos = torch.arange(x.shape[1], device=x.device)
                    x = x + attention(w, p + "attn.",
                                      rms_norm(x, w(p + "ln1"), eps), cfg,
                                      arith, causal=True, positions=pos,
                                      rows=True)
                    h = rms_norm(x, w(p + "ln2"), eps)
                    s = prompts.shape[1]
                    if moe:
                        calls = [h[:, :s].reshape(-1, h.shape[-1])]
                        calls += [h[:, t] for t in range(s, h.shape[1])]
                        ys = moe_calls(w, p + "ffn.", calls, cfg, arith)
                        y = torch.cat([ys[0].reshape(h.shape[0], s, -1),
                                       torch.stack(ys[1:], dim=1)], dim=1)
                    else:
                        y = dense_ffn(w, p + "ffn.", h, cfg["act"], arith)
                    xs[j] = x + y
                    del h, y
        cache.clear()
        for prec, xs in streams.items():
            arith = Arith(prec)
            out[prec] = [logits(w, x[:, prompts.shape[1] - 1:], cfg, arith)
                         for x, (prompts, _) in zip(xs, batches)]
        cache.clear()
    return out
