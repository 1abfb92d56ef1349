"""The benchmark's own arithmetic: data-sheet peaks, the operations and
bytes of the attention kernels, and the work each cell's shapes imply.

The first part is a frozen copy of the program's (``launch/roofline.py``
``PEAK_FLOPS``, ``HBM_BW`` and ``model_flops_for``; ``kernels/attention/
ops.py`` ``live_pairs`` and the K4/K4b FLOP formulas, ``4 d`` and ``10 d``
a live pair; ``kernels/costs.py`` ``io_bytes``' rule, each operand read
once and each output written once), kept here so that a change to the
program cannot move the yardstick. ``test_portbench_costs.py`` holds the
copy equal to the original at today's shapes.

The second part counts, from a configuration and a traffic mix alone,
the work a cell must do: a prefill's operations, a decode step's bytes, a
training step's model operations, and the least time of the attention
work (the larger of its operations at the bf16 peak and its bytes at the
HBM rate), whatever kernel does it.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12

BF16 = 2
F32 = 4


def model_flops_for(kind: str, total_params: int, active_params: int,
                    tokens: int, embed_params: int = 0) -> float:
    """Useful-FLOPs convention: train 6·N_active·D, prefill 2·N_active·D,
    decode 2·N_active·B (tokens == new tokens)."""
    n = active_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def live_pairs(sq: int, skv: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """The (query, key) pairs the causal and window masks let through,
    every key valid (query row ``r`` the global row ``q_offset + r``)."""
    i = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_fwd_flops(b: int, hq: int, sq: int, skv: int, d: int,
                        causal: bool, window: int = 0,
                        q_offset: int = 0) -> int:
    """``4 d`` a live pair: ``2 d`` for ``Q Kᵀ`` and ``2 d`` for ``P V``."""
    return 4 * d * b * hq * live_pairs(sq, skv, causal, window, q_offset)


def attention_bwd_flops(b: int, hq: int, sq: int, skv: int, d: int,
                        causal: bool, window: int = 0,
                        q_offset: int = 0) -> int:
    """``10 d`` a live pair: ``Q Kᵀ`` recomputed, ``dO Vᵀ``, and the three
    gradient products, ``2 d`` each."""
    return 10 * d * b * hq * live_pairs(sq, skv, causal, window, q_offset)


def io_bytes(inputs: list[tuple[int, ...]], outputs: list[tuple[int, ...]],
             itemsize: int) -> int:
    """Each operand read once, each output written once."""
    return itemsize * (sum(math.prod(s) for s in inputs)
                       + sum(math.prod(s) for s in outputs))


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time: operations at the peak or bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


# --------------------------------------------------------------------------- a cell's work


def _h(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def attention_call(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                   causal: bool, backward: bool, lse: bool = False) -> float:
    """The least seconds of one attention call in bf16: the forward (q, k,
    v read, the output and, with ``lse``, each row's float32 log-sum-exp
    written), or the backward (q, k, v, the output, its gradient and the
    log-sum-exp read, dq, dk and dv written)."""
    q, kv = (b, hq, sq, d), (b, hkv, skv, d)
    lse_bytes = b * hq * sq * F32
    if not backward:
        return bound_seconds(
            attention_fwd_flops(b, hq, sq, skv, d, causal),
            io_bytes([q, kv, kv], [q], BF16) + (lse_bytes if lse else 0))
    return bound_seconds(
        attention_bwd_flops(b, hq, sq, skv, d, causal),
        io_bytes([q, kv, kv, q, q], [q, kv, kv], BF16) + lse_bytes)


def _layer_matmul_flops(cfg: dict, tokens: int, cross_tokens: int = 0
                        ) -> float:
    """Operations of one decoder (or encoder) layer's matrix products over
    ``tokens`` rows: the projections, the FFN (an MoE's ``top_k`` experts a
    token and its router), and, with ``cross_tokens`` source rows, the
    cross attention's projections."""
    d, h = cfg["d_model"], _h(cfg)
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    glu = 3 if cfg["act"] in ("swiglu", "geglu") else 2
    proj = 2 * tokens * d * h * (2 * hq + 2 * hkv)
    if cfg.get("num_experts", 0):
        ffn = 2 * tokens * (d * cfg["num_experts"]
                            + cfg["top_k"] * glu * d * cfg["d_ff"])
    else:
        ffn = 2 * tokens * glu * d * cfg["d_ff"]
    cross = 0
    if cross_tokens:
        cross = 2 * tokens * d * h * 2 * hq + 2 * cross_tokens * d * h * 2 * hkv
    return float(proj + ffn + cross)


def prefill_flops(cfg: dict, batch: int, prompt: int) -> float:
    """Operations a decoder-only prefill of ``batch`` prompts must do:
    every layer's products and causal attention over every position, and
    the head at the last position alone (the logits served)."""
    d, h, hq = cfg["d_model"], _h(cfg), cfg["num_heads"]
    per_layer = (_layer_matmul_flops(cfg, batch * prompt)
                 + attention_fwd_flops(batch, hq, prompt, prompt, h, True))
    return cfg["num_layers"] * per_layer + 2.0 * batch * d * cfg["vocab_size"]


def prefill_attention_seconds(cfg: dict, batch: int, prompt: int) -> float:
    """The least seconds of one prefill's sequence attention (every
    layer's causal call)."""
    return cfg["num_layers"] * attention_call(
        batch, cfg["num_heads"], cfg["num_kv_heads"], prompt, prompt,
        _h(cfg), True, False)


def weight_bytes(cfg: dict, batch: int) -> float:
    """Bytes of the weights one decode step of ``batch`` tokens reads in
    bf16: every layer's (every expert counted, as a step of 8 tokens over
    16 experts top 4 reaches 90 % of them on average), the head, and the
    embedding's ``batch`` rows."""
    d, h, f = cfg["d_model"], _h(cfg), cfg["d_ff"]
    hq, hkv, v = cfg["num_heads"], cfg["num_kv_heads"], cfg["vocab_size"]
    glu = 3 if cfg["act"] in ("swiglu", "geglu") else 2
    attn = d * h * (2 * hq + 2 * hkv)
    if cfg.get("num_experts", 0):
        ffn = cfg["num_experts"] * glu * d * f + d * cfg["num_experts"]
    else:
        ffn = glu * d * f
    per_layer = attn + ffn + 2 * d
    head = d * v
    return BF16 * (cfg["num_layers"] * per_layer + head + batch * d + d)


def decode_step_seconds(cfg: dict, batch: int, cache_len: int) -> float:
    """The least seconds of one decode step: its weights and the KV cache
    rows it reads (``cache_len`` a request, the new row written), at the
    HBM rate."""
    kv = (2 * cfg["num_layers"] * batch * cache_len * cfg["num_kv_heads"]
          * _h(cfg) * BF16)
    return (weight_bytes(cfg, batch) + kv) / HBM_BW


def serve_batch_seconds(cfg: dict, batch: int, prompt: int, new: int
                        ) -> float:
    """The least seconds of one served batch: its prefill's operations at
    the peak, then each of its ``new - 1`` decode steps' bytes."""
    t = prefill_flops(cfg, batch, prompt) / PEAK_FLOPS
    for i in range(new - 1):
        t += decode_step_seconds(cfg, batch, prompt + i + 1)
    return t


def train_step_flops(cfg: dict, batch: int, source: int, target: int
                     ) -> float:
    """Model operations of one training step of an encoder-decoder (or a
    decoder-only model with ``source`` 0): the forward once and the
    backward twice its products (``6 N D``), and the attention's ``4 d`` a
    live pair forward and ``10 d`` backward; remat's recomputation is not
    counted."""
    h, hq = _h(cfg), cfg["num_heads"]
    d, v = cfg["d_model"], cfg["vocab_size"]
    enc = cfg.get("encoder_layers", 0)
    fwd = cfg["num_layers"] * _layer_matmul_flops(
        cfg, batch * target, batch * source if enc else 0)
    fwd += 2.0 * batch * target * d * v
    fwd += enc * _layer_matmul_flops(cfg, batch * source)
    attn = 0
    for sq, skv, causal, n in _train_attention_calls(cfg, source, target):
        attn += n * (attention_fwd_flops(batch, hq, sq, skv, h, causal)
                     + attention_bwd_flops(batch, hq, sq, skv, h, causal))
    return 3.0 * fwd + attn


def _train_attention_calls(cfg: dict, source: int, target: int):
    """``(sq, skv, causal, layers)`` of a training step's attention calls."""
    enc = cfg.get("encoder_layers", 0)
    calls = [(target, target, True, cfg["num_layers"])]
    if enc:
        calls += [(source, source, False, enc),
                  (target, source, False, cfg["num_layers"])]
    return calls


def train_attention_seconds(cfg: dict, batch: int, source: int, target: int,
                            microbatches: int) -> float:
    """The least seconds of one training step's attention: each call's
    forward and backward once, a microbatch at a time."""
    mb = batch // microbatches
    hq, hkv, h = cfg["num_heads"], cfg["num_kv_heads"], _h(cfg)
    t = 0.0
    for sq, skv, causal, n in _train_attention_calls(cfg, source, target):
        t += n * (attention_call(mb, hq, hkv, sq, skv, h, causal, False,
                                 lse=True)
                  + attention_call(mb, hq, hkv, sq, skv, h, causal, True))
    return microbatches * t
