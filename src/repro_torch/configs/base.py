"""Model/config dataclasses shared by every architecture.

A config fully determines the model graph; `repro_torch.models.model.build_model`
consumes it. Exact assigned-architecture instantiations live in the sibling
`<arch_id>.py` files; every field here is plain data so configs hash/compare
cleanly and smoke tests can `reduce()` them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | audio
    # trunk
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    act: str = "swiglu"              # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # attention block pattern; one entry per position in the repeating group
    block_pattern: tuple[str, ...] = ("attn",)   # attn | local_attn | rec | ssd
    window: int = 4096               # local_attn sliding window
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    qk_norm: bool = False            # qwen3
    rope_mode: str = "full"          # full | half (chatglm 2d) | mrope (qwen2-vl)
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()   # rotary dims per (t, h, w) section
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False # arctic: dense FFN in parallel with MoE
    moe_dense_d_ff: int = 0          # width of that dense residual (0 => d_ff)
    moe_layout: str = "gather"       # gather: experts TP over 'model', FSDP D over
                                     #   'data' (weights gathered on use)
                                     # a2a: experts over 'data', F over 'model',
                                     #   tokens routed via all-to-all (§Perf HC1)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # RG-LRU (hybrid)
    lru_width: int = 0               # 0 => d_model
    conv_width: int = 4
    # SSD (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    # encoder-decoder
    encoder_layers: int = 0          # >0 => enc-dec (seamless)
    frontend: str = "none"           # none | audio_embeds | vision_embeds
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "compute"  # compute | int8 (quantized decode cache)
    # distribution / memory policy
    remat: str = "block"             # none | block (checkpoint each scan group)
    scan_layers: bool = True

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def group_count(self) -> int:
        """Full repetitions of block_pattern (scanned)."""
        return self.num_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        """Leftover blocks when num_layers % len(block_pattern) != 0."""
        return self.block_pattern[: self.num_layers % len(self.block_pattern)]

    @property
    def attention_free(self) -> bool:
        return all(b in ("rec", "ssd") for b in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True iff no *global* full-attention block exists (long_500k rule)."""
        return all(b in ("rec", "ssd", "local_attn") for b in self.block_pattern)

    # ------------------------------------------------------------- param count
    def param_count(self) -> tuple[int, int]:
        """(total, active-per-token) parameter counts, embeddings included."""
        d, h = self.d_model, self.resolved_head_dim
        attn = d * self.num_heads * h + 2 * d * self.num_kv_heads * h \
            + self.num_heads * h * d
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        dense_ffn = glu * d * self.d_ff
        moe_ffn = glu * d * self.d_ff * self.num_experts
        moe_active = glu * d * self.d_ff * self.top_k
        if self.moe_dense_residual:
            extra = glu * d * (self.moe_dense_d_ff or self.d_ff)
            moe_ffn += extra
            moe_active += extra
        lru = self.resolved_lru_width
        rec = 2 * d * lru + lru * d + self.conv_width * lru + 5 * lru
        di, n = self.ssm_d_inner, self.ssm_state
        ssd = d * (2 * di + 2 * n + self.ssm_heads) + di * d \
            + self.conv_width * (di + 2 * n) + 2 * self.ssm_heads
        per_block = {
            "attn": attn + (moe_ffn if self.is_moe else dense_ffn),
            "local_attn": attn + (moe_ffn if self.is_moe else dense_ffn),
            "rec": rec + dense_ffn,
            "ssd": ssd,
        }
        per_block_active = {
            "attn": attn + (moe_active if self.is_moe else dense_ffn),
            "local_attn": attn + (moe_active if self.is_moe else dense_ffn),
            "rec": rec + dense_ffn,
            "ssd": ssd,
        }
        pattern = list(self.block_pattern) * self.group_count + list(self.tail_pattern)
        total = sum(per_block[b] for b in pattern)
        active = sum(per_block_active[b] for b in pattern)
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + dense_ffn)
            cross = self.num_layers * attn  # decoder cross-attention
            total += enc + cross
            active += enc + cross
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + emb, active + emb

    # ------------------------------------------------------------- reductions
    def reduce(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        shrink = dict(
            num_layers=len(self.block_pattern) * 2 + len(self.tail_pattern),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            window=min(self.window, 32),
            num_experts=min(self.num_experts, 4),
            moe_dense_d_ff=64 if self.moe_dense_residual else 0,
            top_k=min(self.top_k, 2),
            lru_width=64 if self.lru_width else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            mrope_sections=(4, 2, 2) if self.mrope_sections else (),
            param_dtype="float32",
            compute_dtype="float32",
        )
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    microbatches: int = 1            # gradient accumulation factor
    opt_state_dtype: str = "float32" # bfloat16 halves optimizer memory
    grad_compression: str = "none"   # none | int8 (error-feedback all-reduce)
    seed: int = 0
