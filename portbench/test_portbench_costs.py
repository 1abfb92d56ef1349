"""The benchmark's copy of the program's arithmetic (``portbench/costs.py``)
held equal to the original at today's shapes, and the cells' work counts
checked by hand at one shape."""

import pytest
import torch

from portbench import costs

# (b, hq, hkv, sq, skv, d, causal): the cells' K4 and K4b calls
SHAPES = [(8, 48, 8, 2048, 2048, 128, True),      # dbrx's prefill
          (8, 48, 8, 256, 256, 128, True),        # dbrx's chat prefill
          (2, 16, 16, 2048, 2048, 64, False),     # seamless's encoder
          (2, 16, 16, 512, 512, 64, True),        # seamless's decoder
          (2, 16, 16, 512, 2048, 64, False)]      # seamless's cross


def test_peaks_and_model_flops_are_the_programs():
    from repro_torch.launch import roofline

    assert costs.PEAK_FLOPS == roofline.PEAK_FLOPS
    assert costs.HBM_BW == roofline.HBM_BW
    for kind in ("train", "prefill", "decode"):
        assert costs.model_flops_for(kind, 10, 7, 123) == \
            roofline.model_flops_for(kind, 10, 7, 123)


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_flops_and_bytes_are_the_programs(shape):
    from repro_torch.kernels import costs as program_costs
    from repro_torch.kernels.attention import ops

    b, hq, hkv, sq, skv, d, causal = shape
    for window, offset in ((0, 0), (777, 0), (0, skv - sq)):
        assert costs.live_pairs(sq, skv, causal, window, offset) == \
            ops.live_pairs(sq, skv, causal, window, offset)
    q, kv = (b, hq, sq, d), (b, hkv, skv, d)
    assert costs.attention_fwd_flops(b, hq, sq, skv, d, causal) == \
        ops._fwd_flops(q, kv, kv, causal, 0, 0.0, 0)
    assert costs.attention_bwd_flops(b, hq, sq, skv, d, causal) == \
        ops._bwd_flops(q, kv, kv, q, q, q[:3], causal, 0, 0.0, 0)
    meta = [torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in (q, kv, kv)]
    out = torch.empty(q, dtype=torch.bfloat16, device="meta")
    assert costs.io_bytes([q, kv, kv], [q], costs.BF16) == \
        program_costs.io_bytes(tuple(meta), {}, out)


def test_a_prefill_and_a_decode_step_counted_by_hand():
    cfg = dict(num_layers=1, d_model=8, num_heads=2, num_kv_heads=1,
               head_dim=4, d_ff=16, vocab_size=32, num_experts=4, top_k=2,
               act="swiglu")
    b, s = 2, 3
    t = b * s
    proj = 2 * t * 8 * 4 * (2 * 2 + 2 * 1)
    ffn = 2 * t * (8 * 4 + 2 * 3 * 8 * 16)
    attn = 4 * 4 * b * 2 * (1 + 2 + 3)
    head = 2 * b * 8 * 32
    assert costs.prefill_flops(cfg, b, s) == proj + ffn + attn + head
    weights = 8 * 4 * 6 + 4 * 3 * 8 * 16 + 8 * 4 + 2 * 8
    total = 2 * (weights + 8 * 32 + b * 8 + 8)
    kv = 2 * 1 * b * 5 * 1 * 4 * 2
    assert costs.decode_step_seconds(cfg, b, 5) == (total + kv) / costs.HBM_BW
