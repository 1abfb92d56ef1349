"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Runs from the root of a checkout (it reads ``src/repro_torch`` and the
committed scenario files) on a machine with one Hopper card (H100). It
imports nothing of JAX and nothing of the JAX package. Phases:

1. the card's name and power limit (``nvidia-smi``), torch version, and
   compute capability, which must be 9.0;
2. building the kernels from ``src/repro_torch/kernels/*/csrc``, one
   ``nvcc`` for each source, all started together, and the swarm, K4, K5
   and K6 sources once more beside them under ``-Xptxas -v``: no K1, K2,
   K4, K4b, K5 or K6 kernel may spill, K4b's tensor-core dK/dV and dQ
   kernels among them (K2's registers are logged with the grid it chose,
   K6's with their shared memory);
3. K1 (masked rarest-argmin) on the card against its plain PyTorch
   versions, index-exact, in both forms: the dense form (``(k, P)``
   candidates) at the fleet path's shape and on edge cases, and the
   gathered form (the candidates built inside the kernel from the fleet
   state) against ``select_rows_ref`` on a seeded ``n = 10^6, P = 125``
   state and a ``P = 257`` one, on the four stream rules, ``k`` of 1, 7,
   300 and ``n`` with repeated rows, ``other`` at -1, in range and on the
   row's only candidate, rows holding every piece, replica counts at 0
   and near ``n``; timed at ``k = 10^6`` beside the replaced design (the
   candidates built by torch ops, then the dense form);
4. K3 (device checksum) on the card against its plain version, exact,
   on every dtype it reads, lengths 1-7, ``n = b``, ragged ``n``,
   ``block=512``, blocks large enough for the reference's uint32 sums to
   wrap, and a misaligned view;
5. K4 (flash-attention forward) on the card against its plain version:
   the reference's five kernel cases, each also through the public
   ``ops.flash_attention`` (which hands the kernel strided views of the
   model's (B, S, H, D) tensors and must return a contiguous output); keys
   masked past ``skv_valid`` in a full and a ragged tile; q scaled by 8 so
   the scores reach the softcap's bend; all in float32 (2e-5) and bfloat16
   (one unit in the last place: rtol 2^-7, atol 1e-5). Then the serving
   path's prefill shape (B 4, S 4608, Hq 8, Hkv 4, d 256, bfloat16,
   softcap 50) at window 0 and 4096 and recurrentgemma's (Hq 10 over 1,
   window 2048) in both dtypes, to one unit and within a relative L2 band
   that a bf16-probability control must fall outside. Times at both
   prefill shapes against the
   plain version's, the bound (achieved TFLOP/s and share of the bound)
   and ``scaled_dot_product_attention``'s (softcap 0 at gemma2's shape,
   the window as a mask at recurrentgemma's), and, at gemma2's, the
   float32 SIMT kernel's: the arithmetic of the bf16 design it replaced;
   then K4 at gemma2's training shape (one microbatch, B 2, S 2048, with
   ``lse``) against its plain version, timed beside it, SDPA and the
   bound. Then K4b (its backward) against ``attention_bwd_ref`` at gemma2's
   training shape (B 4, Hq 8, Hkv 4, S 2048, d 256, causal, softcap
   50), recurrentgemma's (B 2, Hq 10, Hkv 1, S 4608, window 2048),
   dbrx's (B 2, Hq 48, Hkv 8, S 2048, d 128, causal) and seamless's two,
   non-causal at d 64 (its encoder, B 2, H 16, S 2048; its cross
   attention, 512 queries over 2,048 keys), in float32 (the
   SIMT kernels) and bfloat16 (the tensor cores, P and dS split in two
   bf16 terms), per gradient in relative L2, two calls bit-identical,
   each launch's route as its dtype's; in float32 the controls (no
   softcap derivative with q scaled by 8, delta zero) must fall outside,
   in bfloat16 the unsplit control (``attention_bwd_rounded_ref``
   with bf16 P and dS), beside which the route's own arithmetic in plain
   torch is logged; at gemma2's shape in bfloat16 the tensor-core route,
   the backward of
   ``scaled_dot_product_attention`` (softcap 0) and the plain version
   timed in turns, beside the bound (10 d a live pair at the bf16
   tensor-core rate) and the route's executed TFLOP/s (20 d a pair), and
   at seamless's two shapes the route, SDPA's backward and the plain
   version timed in turns beside the bound.
   Then K4 at the MoE prefill shapes (head dim 128, causal, no softcap:
   q (4, 48, 2048, 128) over k/v (4, 8, 2048, 128), dbrx's, and q (4, 56,
   2048, 128), arctic's), bfloat16, to one unit and within the relative
   L2 band that the bf16-probability control must miss, timed beside the
   plain version, ``scaled_dot_product_attention`` (the same function
   here) and the bound; and at seamless's prefill shapes, non-causal at
   d 64 (the encoder's q/k/v (4, 16, 4096, 64); the cross attention's q
   (4, 16, 512, 64) over k/v of 4,096 and of 4,000 source frames), in
   float32 and bfloat16, to one unit and within the relative L2 band
   that the bf16-probability control must miss, each launch on its
   dtype's route, timed in bfloat16 beside the plain version, SDPA and
   the bound;
5a. K4 and K4b with a query offset (``q_offset``, the global index of
   query row 0), at gemma2's attention (Hq 8 over 4, d 256, softcap 50):
   phase 11's 4,608-token prompts (B 4) prefilled in four chunks of 1,152
   rows, each over its prefix of keys, at window 0 and 4096, each chunk
   against its plain version with the same offset in phase 5's bfloat16
   band (the bf16-probability control outside), the chunks stacked
   against the whole-prompt call in the same band, and each chunk past
   the first launched at offset 0 as the control that must fall outside;
   a ragged offset (1,000 rows from row 1,000 over 2,000 keys) at window
   0 and 777 in float32 (the SIMT route, 2e-5) and bfloat16, each launch
   on its dtype's route, with the offset-0 control; a call that leaves a
   query row no live key refused with ``ValueError`` by the public op and
   both wrappers, no kernel launched; K4b at the second half of phase
   13's microbatch (q ``(2, 8, 1024, 256)`` over k/v ``(2, 4, 2048,
   256)``, ``q_offset`` 1,024, ``lse`` from K4 with the offset) in both
   dtypes within ``K4B_REL_L2``, bit-identical twice, the earlier
   controls and the offset-0 control outside. Each new K4 shape and the
   K4b one timed beside the plain version,
   ``scaled_dot_product_attention`` with an explicit boolean mask
   (softcap 0; its backward for K4b) and the bound from the live pairs
   counted with the offset;
6. K5 (chunked SSD) on the card against its plain version, y and the
   final state: the reference's three cases with and without an initial
   state (also through the public ``ops.ssd_mixer``) and a ragged
   sequence, each in float32 (the SIMT kernel) and bfloat16 (the tensor
   cores), and the mamba2 serving shape (B 4, H 64, S 4600, P 64, N 128,
   chunk 64) with long-memory inputs in both, and one sequence of it in
   bfloat16 from an initial state; elementwise at the reference's 1e-4
   (the worst element's share of it logged) and within a relative-L2
   band that a control dropping the state entering each chunk, and in
   bfloat16 one feeding the tensor cores unsplit float32 operands, must
   fall outside; for the one sequence, the route's arithmetic in plain
   torch and a float64 plain version read beside it; its time at the
   serving shape against the float32 SIMT kernel's on the same inputs
   widened (the design that the tensor-core route replaced) and the plain
   version's;
7. K6 (RG-LRU scan) on the card against its plain version, bit for bit,
   the kernel and ``ops.rglru_scan`` alike: the reference's four cases, a
   ragged sequence and width, and the recurrentgemma serving shape (B 4,
   S 4608, W 2560) with long-memory decays and a non-zero initial state;
   controls restarting every 256 steps (the reference's time block) and
   every 32 (the ring's tile) must differ; timed there one launch at a
   time and 10 back to back, beside the plain version, the bound and a
   ``torch.add`` of the same bytes;
8. the fleet path: ``fleet_scaling.json`` as a 1,000,000-peer flash crowd
   at ``dt = 16`` through ``ScenarioSpec.build("fleet").run()`` exactly as
   committed apart from ``n`` and ``dt`` (a file naming no backend runs the
   device tick), held to the float64 golden of
   ``BENCH_swarm_scaling.json``; K1's and K2's launch counts are read from
   this run alone, K1's by form: every selection must launch the gathered
   form once and none the dense form; the seconds inside the K1 and K2
   dispatches are logged beside the select and waterfill phases;
9. K2 (max-min water-filling, one cooperative launch a call) on the card
   against its plain version, bit-exact (rates, rounds and each round's
   active-flow count; each round's touched slots against the compacted
   plain statement), on flow tables captured from the fleet path and on
   small random topologies (also within 1e-3 of the float64 numpy
   water-fill); one call at the largest table under ``torch.profiler``
   must launch ``waterfill_kernel`` once, its other device operations
   logged;
10. the checkpoint broadcast path: stage 2 of
    ``python -m repro_torch.examples.checkpoint_broadcast`` on an 8 GiB
    (2**33-byte) bundle made from a seed, through a one-rank NCCL group:
    stripe, all-gather, K3 on the replica, ``verify_replicas``; K3's launch
    count is read from this run alone. The replica must equal the payload,
    its checksum must equal the stripe's and K3's plain version's, and a
    bit flipped above index 2**32 must change it;
11. the serving path: ``build_model`` of the full-width ``gemma2_2b``
    (26 layers, 2.61B parameters, bfloat16, weights from a
    ``torch.Generator`` seeded 13 on the card), then
    ``ServeEngine.serve_queue`` over 8 requests of 4,608-token prompts in
    4 slots, 16 greedy new tokens each: two prefills and 30 decode steps.
    K4's launch count, read from this run alone, must be 2 x 26 = 52; a
    second run must give the same tokens; every token must lie in the
    vocabulary; the first batch's decode, replayed, must pick the served
    tokens. Each batch's last-position logits through K4 must agree with
    the same model through the plain attention; then, on the same weights
    cast to float32, so must the first batch's, and each decode step's
    logits with the served tokens fed back must agree with the forward
    pass over the prompt and those tokens (cache lengths past the 4,096
    window). Each agreement is a relative-L2 band; each float32 band must
    leave a lower-precision control (bf16 probabilities, the int8 KV
    cache) outside. Beside the bfloat16 band, logged only: the same logits
    with the plain attention's probabilities split as K4 splits them, and
    through the float32 SIMT kernel on widened inputs (the replaced bf16
    design);
11a. the serving path under a mesh: the same weights and requests
    through ``serve_queue`` under ``set_mesh`` of a one-rank NCCL
    ``make_test_mesh((1, 1), ("data", "model"))``, the parameters as
    DTensors of the rules' layout (``partitioning.shard_module``), with
    the checks of phase 11's run (K4 52 launches, the tokens twice, the
    replayed decode); every decode step's attention through
    ``decode_step_split_kv`` (its calls in the first run counted: 26 x 30
    = 780), the bf16 greedy tokens logged beside phase 11's with the
    number that differ, the wall and ms a decode step beside phase 11's;
    then on the float32 weights, the teacher-forced decode through the
    split-KV step past the 4,096 window within phase 11's band, which the
    split-KV step without its window mask and the int8 cache through it
    must miss, and the first batch's float32 greedy tokens equal to the
    mesh-less engine's;
12. the state serving paths, ``mamba2_1_3b`` (48 ssd layers, 4,600-token
    prompts: the last SSD chunk ragged) and ``recurrentgemma_2b`` (18 rec
    and 8 local-attention layers, 4,608-token prompts past the 2,048
    window), at full width from seed 14 with the decay parameters redrawn
    from the published init ranges, each through ``build_model`` and
    ``ServeEngine.serve_queue`` as in phase 11: launches (K5 96; K6 36
    and K4 16), the same tokens twice, the replayed decode; mamba2's bfloat16
    prefill as served, its logits and its first ssd block through K5
    against the plain version, each within a band from chip readings that
    the no-carry and unsplit-operand controls must fall outside; on the
    weights cast to float32, the prefill logits
    through the kernels against their plain versions and the
    teacher-forced decode (the recurrent step after K5's or K6's hand-off)
    against the forward pass, each within a band that its controls (state
    dropped between chunks or blocks; state zeroed or conv tail dropped at
    the hand-off) must fall outside;
13. the training path: full-width ``gemma2_2b`` (seed 19, bfloat16)
    trained by ``Trainer.run`` under ``run_with_restarts`` for 4 steps of
    4 x 2,048 tokens from a ``HostBatcher`` over a ``ShardedCorpus``, 2
    microbatches, bfloat16 moments, remat per group, one checkpoint at the
    last step in a directory under ``build/`` that is deleted after. K4's
    and K4b's launches, read from this run alone, must be 2 x 2 x 26 = 104
    and 2 x 26 = 52 a step (two forwards a layer and microbatch under
    remat), every K4b launch on the tensor cores; every loss finite;
    seconds a step, tokens/s,
    K4b's share of a step (CUDA events around its calls) and the peak
    memory logged. The
    checkpoint, restored into a fresh ``TrainState``, must equal the
    trained state leaf for leaf (save and load seconds and bytes logged);
    its parameters, loaded into a fresh serving model, must serve the
    in-memory parameters' greedy tokens; 3 more steps on one fixed batch
    must lower its loss;
13a. the elastic restore: phase 13's checkpoint, before its directory
    is deleted, through ``load_checkpoint(..., shardings=Partitioner(
    mesh).tree_shardings(...))`` onto a one-rank NCCL (1, 1) ("data",
    "model") mesh: the parameters and both moments, every leaf a DTensor
    on that mesh with the rules' placements and equal to the trained
    state's; the load seconds beside phase 13's in-place restore;
13b. the mesh-aware train step: full-width ``gemma2_2b`` through
    ``make_train_step(..., mesh=make_test_mesh((1, 1, 1), ("pod", "data",
    "model")), pod_axis="pod", grad_shardings=...)``, the parameters and
    both moments as DTensors of the rules' layout (``shard_train_state``),
    2 steps on phase 13's first two batches
    (2 microbatches, remat, bfloat16 moments), against 2 steps of the
    mesh-less step from the same initial state: bit-identical states and
    metrics, K4 104 and K4b 52 launches a step on the tensor cores,
    seconds a step logged; then the cross-pod mean of one full-width
    step's gradients over the one-rank NCCL pod group (quantise with one
    scale a reference leaf, all-gather, dequantise, average) bit for bit
    against the same arithmetic in plain torch, and ``q·scale + new
    residual`` equal to ``grad + residual`` within float32 rounding;
14. float32 gradient checks at full width and reduced depth (gemma2_2b 4
    layers, mamba2_1_3b 2, recurrentgemma_2b 3, the decays redrawn as in
    phase 12): one step's gradients through the kernels against the same
    step through their plain versions, by relative L2 per leaf, within a
    band from chip readings that the controls (K4b without the softcap
    derivative, K4b with delta zero, K4b on bf16-rounded operands, K6's
    backward without the carried adjoint) must fall outside; gemma2's
    query projections scaled by 1/8 so that its scores sit in the
    softcap's bend, with a witness of the seeded and the scaled scores
    (their size against the cap, and how much of ``P (1 - tanh^2)``
    float32 rounding leaves); and K6's gradient at its serving shape
    with an initial state, bit-exact with the plain scan run backwards,
    against a control that drops dh0;
15. crash and restart: gemma2_2b at full width and 2 layers, 6 steps with
    a checkpoint every 2 and a crash at step 3 under ``run_with_restarts``,
    must end bit-identical to an uninterrupted run; its last checkpoint
    through ``checkpoint_metainfo`` and ``restore_from_bundle`` must come
    back byte for byte;
16. ``python -m repro_torch.launch.train`` (10 steps), then ``python -m
    repro_torch.launch.serve --ckpt-dir`` and ``python -m
    repro_torch.launch.elastic --ckpt-dir`` on its checkpoint, on the card
    at their reduced config, each printing its ``done step=``, ``restored
    from`` or ``resharded ... data cursor`` line;
16a. the user walkthroughs, each ``python -m
    repro_torch.examples.<name>``'s ``main`` called in this process (so
    that the kernel counters see its launches) with its standard output
    logged: ``quickstart`` (its four stages, "all four stages OK"),
    ``serve_lm`` (every request served on the card), ``train_lm --preset
    paper-100m`` (300 steps; the median train step, synchronised, the
    wall a step with checkpoints included, and the first and last logged
    loss) and ``train_lm --preset smoke --inject-crash-at 50`` (one
    restart, step 100), K4 launched by each and K4b by the three that
    train (the reduced configs compute in float32: the SIMT routes),
    every loss finite; the first K4 and K4b call of each signature in
    each run kept and held against the plain version on its own inputs
    (K4 elementwise within the reference's float32 tolerance, which the
    bf16-probability control breaks; K4b within ``K4B_REL_L2``, which the
    delta-zero control misses);
17. the MoE serving paths, ``dbrx_132b`` (16 experts, top 4) at 8 of its
    40 layers and ``arctic_480b`` (128 experts, top 2, a dense residual) at
    2 of its 35, at full width (capacity factor 1.25) from seed 21, each
    through ``build_model`` (drawn leaf by leaf into the model: 27.3B and
    27.7B bfloat16 parameters) and ``ServeEngine.serve_queue`` over 8
    requests of 2,048-token prompts in 4 slots, 16 greedy new tokens: K4
    launched 16 and 4 times, the same tokens twice, the replayed decode,
    the (token, slot) pairs dropped at capacity in each prefill and decode
    step logged; each batch's prefill logits through K4 against the plain
    attention, logged with the (token, layer) pairs whose top-k experts
    differ between the two runs (routing flips; the seeded attention is
    one-hot, so a last-bit difference grows to O(1) within a few blocks);
    every block, fed the plain run's input and routing, held within a band
    from chip readings that the bf16-probability control must miss; one
    prefill's MoE time by stage (router and top-k, dispatch, expert
    products, combine, aux losses, dense residual, the rest of
    ``moe_apply``) under CUDA events recorded around ``models/moe.py``'s
    own calls; then, drawn in float32 at 2 and 1 layers, the prefill
    logits with the plain run's routing imposed within a band the
    bf16-probability control must miss, and the teacher-forced decode against the forward pass at
    capacity factor E / k (no pair dropped on either side, counted) within
    a band the int8 KV cache must miss;
18. expert parallelism on one card: one full-width dbrx MoE layer in
    float32 through ``EPContext`` over a one-rank NCCL ``DeviceMesh`` (1,
    1) ("data", "model"), its parameters the rules' DTensor shards of each
    layout, the gather and the all-to-all layout, each within 1e-5 of the
    local path (y, lb, z);
19. the MoE training path: full-width ``dbrx_132b`` at 1 layer trained by
    ``Trainer.run`` for 3 steps on one fixed 2 x 2,048 batch of the
    byte-level corpus (bfloat16 moments, remat, one microbatch): the loss
    falling, ``moe_lb`` and ``moe_z`` finite, K4 2 and K4b 1 launches a
    step on the tensor cores, seconds a step and peak memory logged;
20. the encoder-decoder serving path: the full-width, full-depth
    ``seamless_m4t_medium`` (12 encoder and 12 decoder layers, 614.7M
    bfloat16 parameters from seed 22) through ``build_model`` and two
    ``ServeEngine.generate(prompts, src_embeds)`` calls of 4 requests,
    each a 4,096-frame source drawn from the seed (the frontend is a
    stub) and a 512-token prompt, 16 greedy new tokens: K4 36 times a
    prefill (encoder non-causal, decoder self causal, cross non-causal
    with 512 queries over 4,096 keys), 72 in all, every launch bfloat16
    on the tensor cores; the same tokens twice and the replayed decode;
    the attention's sharpness at the first encoder, decoder-self and
    cross layers logged (the seeded attention is one-hot, so a last-bit
    difference grows to O(1) within a few blocks: the bfloat16 depth is
    held block by block, each block fed the plain run's input and
    memory, within bands, the encoder's and the decoder's, that the
    bf16-probability control must miss); then, drawn in float32 at 1 + 1
    layers, the prefill logits through K4 against the plain attention
    within a band that the encoder run causal, the memory zeroed and the
    bf16-probability control must miss, and the teacher-forced decode
    against the forward pass within a band that the cross cache zeroed at
    the hand-off must miss;
21. the encoder-decoder training path: the full-width, full-depth
    seamless (every query projection scaled by 1/8: at the seeded scale
    the one-hot attention makes the encoder's gradients so large that
    clipping stalls the loss; the two gradient norms are logged) trained 3
    steps through ``make_train_step``
    on one fixed batch of 4 x (2,048 source frames, 512 byte-level
    tokens), 2 microbatches, remat, bfloat16 moments: the loss finite and
    falling every step, K4 432 and K4b 216 launches on the tensor cores;
    then float32 gradients at 2 + 2 layers (the same scaling) through the
    kernels against their plain versions, within a band that K4b with
    delta zero and K4b on bf16-rounded operands must miss, every encoder
    leaf's gradient non-zero;
21a. the production-mesh dry-run: ``python -m repro_torch.launch.dryrun
    --arch gemma2_2b`` for ``train_4k`` on both production meshes (16 x 16
    and 2 x 16 x 16 fake ranks) and ``prefill_32k`` and ``decode_32k`` on
    the single-pod mesh, each a process of its own (the fake default group
    cannot share a process with the NCCL groups here), all started
    together with 21b's after the timed phases (they take the host's
    cores): every cell ``ok``, each logged with its per-device
    predictions at H100 data-sheet constants;
21b. the dry-run against the card: the dry-run's cell of phase 13's
    configuration on a one-rank mesh (a process started with 21a's),
    against one real
    step of it on a one-rank NCCL mesh (1, 1, 1), parameters and moments
    as the rules' DTensors: the predicted per-device FLOPs equal to
    ``FlopCounterMode``'s count of the real step, the predicted peak
    within 20 % of ``torch.cuda.max_memory_allocated`` (the ratio
    logged), two more steps no faster than the cell's ``t_bound`` (their
    time over it logged), K4 104 and K4b 52 launches in the step;
22. K4's, K4b's and K5's route checks: every bfloat16 launch of K4, K4b
    and K5 in the whole run must have taken the tensor-core route and
    every float32 launch the SIMT one, as the launch that ran reports its
    route (each wrapper counts launches by dtype and route), and each
    path's launches by route must add up to its count;
23. one JSON line of per-kernel numbers (K4's with its MoE-shape and
    offset readings, K4b's with its offset readings, the walkthroughs'
    launches by path), then the last line ``{"ok": true, "device":
    {...}}``.

The parameter count of every serving path is checked against the
config's, block kind by block kind.

Any failed check raises, so the script exits non-zero before the last
line. Without CUDA, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENARIO = ROOT / "benchmarks" / "scenarios" / "fleet_scaling.json"
GOLDENS = ROOT / "BENCH_swarm_scaling.json"
N_PEERS = 1_000_000
DT = 16.0
GOLDEN_ROW = "scaling/fleet_n1000000"
# H100 SXM data sheet: HBM rate, float32 outside the tensor cores, and the
# dense bfloat16 tensor-core rate; 32-bit integer operations run on half as
# many lanes (64 INT32 against 128 FP32 a streaming multiprocessor)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
I32_OPS_PER_S = F32_OPS_PER_S / 2
# the shared memory a block can take (dynamic, after the attribute is set)
MAX_SHARED_BYTES = 232448
SWARM_SOURCE = "src/repro_torch/kernels/swarm/csrc/swarm_kernels.cu"
CHECKSUM_SOURCE = "src/repro_torch/kernels/checksum/csrc/checksum_kernels.cu"
ATTENTION_SOURCE = (
    "src/repro_torch/kernels/attention/csrc/attention_kernels.cu")
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_kernels.cu"
RGLRU_SOURCE = "src/repro_torch/kernels/rglru/csrc/rglru_kernels.cu"
# the serving path: full-width gemma2_2b, 8 requests of 4,608 tokens in 4
# slots, 16 greedy new tokens (4,608 > the 4,096 window of the local layers)
SERVE_ARCH = "gemma2_2b"
SERVE_SEED = 13
SERVE_REQUESTS = 8
SERVE_PROMPT = 4608
SERVE_SLOTS = 4
SERVE_NEW = 16
# the reference's five kernel cases (tests/test_kernels.py:25-29):
# b, sq, skv, hq, hkv, d, causal, window, softcap
K4_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),
    (1, 192, 192, 4, 4, 32, True, 0, 50.0),
    (2, 256, 256, 8, 2, 64, True, 64, 0.0),
    (1, 64, 320, 2, 1, 128, False, 0, 0.0),
    (1, 130, 130, 2, 2, 16, True, 0, 0.0),
]
# K4 against its plain version, (atol, rtol) per dtype. Float32: the
# reference's own 2e-5. Bfloat16: both sides compute in float32 and round
# once, so they may land one unit in the last place apart, at most 2^-7 of
# the value; 1e-5 absolute covers values near zero, where the two float32
# sums' own difference (about 1e-6) exceeds a unit.
# recurrentgemma's local-attention prefill (b, s, hq, hkv, d) and window:
# 10 query heads over one key/value head, no softcap
K4_RECURRENTGEMMA = (4, 4608, 10, 1, 256)
K4_RECURRENTGEMMA_WINDOW = 2048
K4_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# Relative-L2 bands, each set from H100 readings (PERF.md, serving: sound
# run / lower-precision control) and, where the control stands apart, near
# the geometric mean of the two; the script fails if a control falls inside.
# K4 against its plain version at the prefill shape (4.4e-5 / 2.5e-3 with
# bfloat16 probabilities); the prefill's last-position logits through K4
# against the plain attention in float32 (1.8e-6 / 1.5e-3) and in bfloat16
# as served (7.7e-3 / 9.6e-3: 26 layers of bfloat16 rounding hide the
# control, so that band only sits 10 % above the reading); the float32
# teacher-forced decode against the forward pass (4.5e-6 / 3.0e-4 with the
# int8 KV cache).
K4_REL_L2 = 3e-4
# the kernel that K4, K4b and K5 must launch for each dtype
DTYPE_ROUTE = {"bfloat16": "tensor_core", "float32": "simt"}
LOGITS_BAND_F32 = 5e-5
LOGITS_BAND_BF16 = 8.5e-3
DECODE_BAND_F32 = 4e-5
# K6: the reference's four cases (tests/test_kernels.py:44-53, b, s, w), a
# sequence and width that are no multiple of the ring's tile (32 steps) and
# CTA (32 channels), and the recurrentgemma serving shape with long-memory
# decays
K6_CASES = [(2, 64, 32), (1, 300, 100), (3, 512, 256), (1, 16, 8)]
K6_RAGGED = (2, 1237, 333)
K6_SERVING = (4, 4608, 2560)
K6_LONG_MEMORY = (0.99, 0.9999)
K6_RESTART = 256    # the reference's time block (rglru/ops.py block_t)
# K5: the reference's three cases (tests/test_kernels.py:56-68: b, h, s, p,
# n, chunk), each with and without an initial state, a ragged sequence, and
# the mamba2 serving shape (S 4600: the last chunk is ragged) with
# long-memory inputs, dt in U(1e-3, 1e-2) and a in -U(0.1, 0.5), so that
# exp(acum) stays near 1 across a chunk and the carried state dominates
K5_CASES = [(c, h0) for c in [(2, 4, 64, 16, 16, 16), (1, 2, 130, 32, 64, 32),
                              (2, 8, 256, 64, 128, 64)]
            for h0 in (False, True)] + [((2, 8, 1000, 64, 128, 64), True)]
K5_SERVING = (4, 64, 4600, 64, 128, 64)
K5_DT_LONG = (1e-3, 1e-2)
K5_A_LONG = (0.1, 0.5)
# K5 against its plain version in relative L2, y and h_last alike: near
# the geometric mean of the largest H100 reading (6.2e-7) and the smallest
# no-carry control (1.8e-3, a short-memory h_last), PERF.md
K5_REL_L2 = 3e-5
# the kernel that each block kind launches once per prefill
KERNEL_OF_KIND = {"attn": "flash_attention", "local_attn": "flash_attention",
                  "ssd": "ssd_chunked", "rec": "rglru_scan"}
# the state serving paths: full width, 8 requests in 4 slots, 16 greedy new
# tokens (SERVE_* above), weights from seed 14 with the decays redrawn.
# Per arch: the prompt's tokens; the depth (layers) of the float32
# end-to-end checks, the float32 prefill-logits and decode bands there and
# the attention decode faults (DECODE_FAULTS) that the decode band must
# catch besides the state hand-off controls; the {block kind: (prefill
# band, decode band)} of ``layerwise_check`` at full depth. mamba2's 4,600
# tokens leave its last SSD chunk ragged; recurrentgemma's 4,608 pass its
# 2,048 window. Each band sits near the geometric mean of an H100 reading
# and its nearest control (PERF.md): mamba2 logits 6.3e-6 / 3.0e-4, decode
# 9.4e-6 / 8.4e-4; layer by layer, ssd 1.3e-6 / 1.5e-4 and 1.7e-6 /
# 6.7e-4, rec 7.4e-6 / 1.7e-2 and 1.0e-5 / 7.5e-3, local_attn 7.5e-8 /
# 2.1e-4 and 3.8e-4 / 1.36. recurrentgemma is held end to end at its first
# (rec, rec, local_attn) group and the (rec, rec) tail, 5 of its 26 layers:
# logits 1.1e-7 / no-carry 0.31; decode 4.4e-4 at a near-tie (median
# 2.3e-6) / conv tail dropped 0.29, state zeroed 0.64, window dropped 1.37.
# With these weights its scores have a std of about 810 and each row's
# largest probability rounds to 1 in float32 (``attention_sharpness``), so
# each further local-attention layer multiplies a rounding difference by up
# to 230 (5e-8 after the first reads 0.34 after the last; the decode reads
# 8.5e-3 at 8 layers), and a window one key too wide or the new row unseen
# leave the decode exactly as it was; the layer-by-layer check holds every
# block at full depth. mamba2's bfloat16 prefill as served, through K5's
# tensor-core route against the plain version, each band near the
# geometric mean of the H100 reading and its nearest control: the logits
# (``bf16_logits_band``) 1.8e-2 / unsplit operands 3.6e-2, no-carry 4.0e-2;
# the first ssd block (``bf16_block_band``) 0 (no element's bf16 rounding
# moved; 6.2e-6 with two-term operands) / unsplit 1.8e-4, no-carry 6.7e-4
STATE_SEED = 14
STATE_SERVING = {
    "mamba2_1_3b": dict(
        prompt=4600, layers=48, logits_band=4e-5, decode_band=4e-5,
        decode_faults=(), layer_bands={"ssd": (1.5e-5, 3e-5)},
        bf16_logits_band=2.6e-2, bf16_block_band=3e-5),
    "recurrentgemma_2b": dict(
        prompt=4608, layers=5, logits_band=2e-4, decode_band=1e-2,
        decode_faults=("window dropped",),
        layer_bands={"rec": (3e-4, 2.5e-4), "local_attn": (3e-6, 2e-3)}),
}
# the training path: full-width gemma2_2b from seed 19, 4 steps of 4 x 2,048
# tokens (a HostBatcher over a ShardedCorpus of CorpusSpec's byte-level
# vocabulary, 259 ids of the model's 256,000, so that 4 steps can show
# the loss fall) in 2 microbatches, bfloat16 moments (a reference option,
# tests/test_train.py:91), one checkpoint at the last step; from it, 4
# requests of 256 tokens, 8 greedy new tokens
TRAIN_ARCH = "gemma2_2b"
TRAIN_SEED = 19
TRAIN_STEPS = 4
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_CONFIG = dict(learning_rate=1e-4, warmup_steps=1, total_steps=8,
                    microbatches=2, opt_state_dtype="bfloat16",
                    seed=TRAIN_SEED)
TRAIN_SERVE = (4, 256, 8)
# crash and restart: gemma2_2b at full width and 1 group (2 layers: one
# local, one global; cut from 4 to keep the whole script near its earlier
# wall beside the encoder-decoder phases), 6 steps of 4 x 512 tokens, a
# checkpoint every 2 steps, the crash at step 3
CRASH = dict(layers=2, batch=4, seq=512, steps=6, every=2, at=3)
# K4b against its plain version: gemma2's training shape ((b, hq, hkv, sq,
# skv, d), causal, window, softcap: causal, softcap 50), recurrentgemma's
# (window 2048), dbrx's (head dim 128, 48 query heads over 8, no softcap)
# and seamless's two, non-causal (its encoder, Sq = Skv = 2,048, and its
# cross attention, 512 decoder queries over 2,048 source keys), relative
# L2 per gradient: float32 (the SIMT kernels) about 8x the largest H100 reading
# (1.2e-6, q scaled by 8; the controls read 0.25 and more there); bfloat16
# set when both dtypes ran the SIMT kernels (3.0e-5 read), which the
# tensor-core route (P and dS split in two bf16 terms, about 1e-4 in plain
# torch, ``attention_bwd_rounded_ref``) must hold and the unsplit control
# (bf16 P and dS, 2.5e-3) must miss
K4B_CASES = [((4, 8, 4, 2048, 2048, 256), True, 0, 50.0),
             ((2, 10, 1, 4608, 4608, 256), True, 2048, 0.0),
             ((2, 48, 8, 2048, 2048, 128), True, 0, 0.0),
             ((2, 16, 16, 2048, 2048, 64), False, 0, 0.0),
             ((2, 16, 16, 512, 2048, 64), False, 0, 0.0)]
# the seamless cases of K4B_CASES, timed beside SDPA's backward
K4B_SEAMLESS = {"encoder": 3, "cross": 4}
K4B_REL_L2 = {"float32": 1e-5, "bfloat16": 2e-4}
# operations K4b's tensor-core route executes against its bound's 10 d a
# live pair: S and dP in both kernels, and dV, dK and dQ on P or dS split in
# two bf16 terms (20 d)
K4B_EXECUTED = 2
# phase 5a: the chunked prefill of phase 11's prompts in K4_CHUNKS chunks
# (each chunk's rows over every key up to its end, q_offset its first
# row) at the global layers' window 0 and the local layers' 4096; a ragged
# offset (1,000 rows from row 1,000 over 2,000 keys: no tile edge lines
# up) at window 0 and 777 (which bites there); K4b with the offset at the
# second half of phase 13's microbatch, ((b, hq, hkv, sq, skv, d),
# q_offset, softcap)
K4_CHUNKS = 4
K4_OFFSET_WINDOWS = (0, 4096)
K4_RAGGED = dict(b=2, sq=1000, skv=2000, q_offset=1000, windows=(0, 777))
K4B_OFFSET = ((2, 8, 4, 1024, 2048, 256), 1024, 50.0)
# float32 gradient checks at full width and reduced depth: the kernels
# against their plain versions, one step, relative L2 per leaf, and the
# controls that must fall outside each arch's band. gemma2's query
# projections are scaled by ``wq_scale`` so that its scores sit in the
# softcap's bend, not far past the cap as at the seeded init (wq's std
# 1/sqrt(8) by the fan-in rule; ``softcap_witness`` logs both). Bands
# about 4-5x the H100 reading (PERF.md): gemma2 1.17e-4 on wq, whose
# gradient moves 1.27e-5 when the plain version's operands move one ulp
# (the bf16-operand control 0.128); mamba2 6.0e-6 (the no-carry control
# 2.4e-4: the band near their geometric mean), recurrentgemma 5.6e-6
# (controls 0.99, 27)
GRAD_CHECKS = {
    "gemma2_2b": dict(layers=4, batch=1, seq=1024, wq_scale=0.125, controls=(
        "K4b without the softcap derivative", "K4b with delta zero",
        "K4b on bf16-rounded operands"),
        witnesses=("K4b's plain version on operands one ulp apart",)),
    "mamba2_1_3b": dict(layers=2, batch=1, seq=1000, controls=(
        "K5 without the carried state",)),
    "recurrentgemma_2b": dict(layers=3, batch=1, seq=2560, controls=(
        "K6's backward without the carried adjoint", "K4b with delta zero")),
}
GRAD_REL_L2 = {"gemma2_2b": 5e-4, "mamba2_1_3b": 3e-5,
               "recurrentgemma_2b": 3e-5}
GRAD_K6 = (4, 4608, 2560)
# the MoE paths: dbrx_132b (16 experts, top 4) and arctic_480b (128, top 2,
# a dense residual) at full width (widths, experts, top_k, capacity factor
# 1.25, vocabularies as published) and a depth one card holds: weights from
# seed 21, bfloat16, 8 requests of 2,048-token prompts in 4 slots, 16 greedy
# new tokens (SERVE_*); then drawn in float32 at a smaller depth (arctic at
# 2 x 512 tokens), the teacher-forced decode at capacity factor E / k (no
# pair dropped). The seeded attention is one-hot (score std 313 and 338,
# the init rule's fan-in of wq being the query heads), so a last-bit
# difference in one block moves the next by far more (PERF.md: dbrx's
# blocks, chained with one routing, read 4.0e-4, 2.3e-2, 0.16 ... 0.97 in
# bfloat16): the served depth's end-to-end bfloat16 logits are logged, and
# held block by block, each block fed the plain run's input and routing
# (``block_band``, which the bf16-probability control must miss: dbrx's
# blocks read 4.0e-4-6.8e-4 / control 1.44e-3-2.46e-3, arctic's 4.3e-4,
# 5.4e-4 / 1.43e-3, 1.82e-3); end to end in float32 at the cut depth
# (``logits_band``: dbrx 5.0e-6 / control 8.7e-3, arctic 2.3e-7 / 1.9e-4;
# ``decode_band``, over the decode steps: dbrx 2.4e-3 max / the int8 cache
# 7.6e-3 min, 0.74 max, arctic 1.1e-4 / 7.5e-3, 0.32), each band near the
# geometric mean of a reading and its control (for the decode, of the
# largest step reading and the control's largest step, which alone must
# pass the band, as in ``teacher_forced_check``: dbrx's band lies above
# the control's smallest step, arctic's just under it)
MOE_SEED = 21
MOE_PROMPT = 2048
MOE_SERVING = {
    "dbrx_132b": dict(layers=8, block_band=1e-3, f32_layers=2,
                      f32_prompt=(4, 2048), logits_band=2e-4,
                      decode_band=4e-2),
    "arctic_480b": dict(layers=2, block_band=1e-3, f32_layers=1,
                        f32_prompt=(2, 512), logits_band=6e-6,
                        decode_band=6e-3),
}
# expert parallelism on one card: one full-width dbrx MoE layer in float32
# over a one-rank mesh, (batch, tokens)
MOE_EP_TOKENS = (2, 2048)
# MoE training: full-width dbrx_132b at 1 layer, 3 steps of one fixed 2 x
# 2,048 batch of the byte-level corpus, one microbatch (the float32
# gradient accumulator of two would add 17 GiB), bfloat16 moments
MOE_TRAIN_ARCH = "dbrx_132b"
MOE_TRAIN_STEPS = 3
MOE_TRAIN_BATCH = 2
MOE_TRAIN_CONFIG = dict(TRAIN_CONFIG, microbatches=1, seed=MOE_SEED)
# the encoder-decoder paths: full-width seamless_m4t_medium (12 encoder and
# 12 decoder layers, d 1,024, 16 heads of 64, 256,206 tokens, tied) from
# seed 22. Serving: 8 requests in two ``generate(prompts, src_embeds)``
# calls of 4, each a 4,096-frame source (frame embeddings drawn from the
# seed: the frontend is a stub) and a 512-token prompt, 16 greedy new
# tokens; K4 36 times a prefill (12 encoder, 12 decoder self and 12 cross
# layers). The seeded attention is one-hot (score std 64 in all 36 layers:
# the init rule's fan-in of wq is the 16 query heads), so a last-bit
# difference grows to O(1) within five encoder blocks (chained bf16 blocks
# read 2.6e-4, 8.0e-3, 6.0e-2, 0.24, 0.50 ... 1.38) and float32 end to end
# is held at 1 + 1 layers (``deeper``: the 2 + 2 reading, logged, is already
# two orders of magnitude up). ``block_band``: each bfloat16 block, fed the
# plain run's input and memory, through K4 against the plain attention,
# which the bf16-probability control must miss (encoder blocks 2.6e-4-4.6e-4
# / control 2.35e-3-4.2e-3; decoder blocks, self and cross attention,
# 2.4e-3-2.8e-3 / 1.40e-2-1.96e-2); ``f32``: drawn in float32 at 1 + 1
# layers, the prefill logits through K4 against the plain attention
# (``logits_band``: 6.1e-6 / bf16-probability control 7.5e-3, memory zeroed
# 0.74, encoder causal 0.93) and the teacher-forced decode against the
# forward pass (``decode_band``: at most 1.2e-4 / the cross cache zeroed
# 0.70 at least). Each band near the geometric mean of the largest H100
# reading and the nearest control (PERF.md)
ENCDEC_ARCH = "seamless_m4t_medium"
ENCDEC_SEED = 22
ENCDEC_SERVING = dict(requests=8, batch=4, source=4096, prompt=512, new=16,
                      block_band={"encoder": 1e-3, "decoder": 6e-3},
                      f32=dict(encoder_layers=1, layers=1,
                               logits_band=2e-4, decode_band=8e-3,
                               deeper=(2, 2)))
# training: 3 steps of one fixed batch of 4 x (2,048 source frames, 512
# target tokens of the byte-level corpus) through ``make_train_step`` (the
# ``Trainer``'s pipeline carries no source, in the reference too), 2
# microbatches, remat, bfloat16 moments, no checkpoint, every query
# projection scaled by ``wq_scale`` (score std 8): at the seeded scale the
# one-hot attention makes the encoder's gradients grow with depth until
# their global norm is many orders of magnitude above the scaled model's
# (both logged), so clipping to norm 1 leaves every other gradient under
# Adam's epsilon and the loss does not fall. Then float32 gradients at 2 + 2
# layers (full width, 1 x (2,048, 512), the same scaling) through the
# kernels against their plain versions, worst leaf in relative L2 within
# ``band``, about 5x the H100 reading (1.06e-4; the plain version's backward
# on operands one ulp apart moves it 5.4e-6), which K4b on bf16-rounded
# operands (5.3e-2) and with delta zero (111) must miss
ENCDEC_TRAIN = dict(batch=4, source=2048, target=512, steps=3,
                    wq_scale=0.125)
ENCDEC_TRAIN_CONFIG = dict(TRAIN_CONFIG, seed=ENCDEC_SEED)
ENCDEC_GRAD = dict(encoder_layers=2, layers=2, batch=1, source=2048,
                   target=512, band=5e-4, wq_scale=0.125)
# K4 at the MoE prefill shapes (b, s, hq, hkv, d): causal, no softcap
K4_MOE = {"dbrx_132b": (4, MOE_PROMPT, 48, 8, 128),
          "arctic_480b": (4, MOE_PROMPT, 56, 8, 128)}
# K4 at seamless's prefill shapes, non-causal, no softcap: name -> (b, hq,
# hkv, sq, skv, d): the encoder's self attention over a 4,096-frame source
# and the cross attention, 512 decoder queries over a source of 4,096 and
# of 4,000 frames (no multiple of the kv tile)
K4_SEAMLESS = {"encoder": (4, 16, 16, 4096, 4096, 64),
               "cross": (4, 16, 16, 512, 4096, 64),
               "cross, ragged source": (4, 16, 16, 512, 4000, 64)}
# the dry-run's production-mesh cells of gemma2_2b (shape, mesh), each a
# process of its own (the fake default group is global to its process)
# phase 16a: the user walkthroughs, (module, arguments) of ``python -m
# repro_torch.examples.<module>``, on the card at the reference's defaults
WALKTHROUGHS = [("quickstart", []), ("serve_lm", []),
                ("train_lm", ["--preset", "paper-100m"]),
                ("train_lm", ["--preset", "smoke", "--inject-crash-at", "50"])]
DRYRUN_CELLS = [("train_4k", "both"), ("prefill_32k", "single"),
                ("decode_32k", "single")]
# the dry-run against the card: its predicted peak within this share of
# the measured peak
DRYRUN_PEAK_BAND = 0.2
# the checkpoint bundle: 2**33 bytes, a bf16 checkpoint of ~4.3B parameters
BUNDLE_BYTES = 1 << 33
BUNDLE_SEED = 12
FLIP_AT = (1 << 32) + 12345


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


@contextlib.contextmanager
def phase(name: str):
    """Log the wall seconds of the phase run inside."""
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ timing


def median_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median wall of ``fn`` on the card, each run between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def steady_ms(fn, launches: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the wall of ``launches`` back-to-back runs
    of ``fn`` between CUDA events, divided by ``launches``: the device time
    of one run with the queue kept full, without the host's time to reach
    the first launch, which ``median_ms`` counts."""
    return median_ms(lambda: [fn() for _ in range(launches)],
                     reps=reps) / launches


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S,
          tensor_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over their peak (float32
    unless ``ops_per_s`` says otherwise), plus ``tensor_ops`` more at the
    bf16 tensor-core rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (nops / ops_per_s + tensor_ops / BF16_TENSOR_OPS_PER_S) * 1e3
    by = "bytes" if by_bytes >= by_ops else "operations"
    return max(by_bytes, by_ops), by


# ------------------------------------------------------------------ K1


def k1_inputs(rng, k, P, density=0.5, avail_hi=1_000_000, avail_lo=0,
              quantized=False):
    import numpy as np

    cand = rng.random((k, P)) < density
    avail = rng.integers(avail_lo, avail_hi, P).astype(np.float32)
    if quantized:
        jitter = (rng.integers(0, 4, (k, P)) / 4.0).astype(np.float32)
    else:
        jitter = rng.random((k, P), dtype=np.float32)
    return cand, avail, jitter


def check_k1_dense(kernels, dev):
    """K1's dense form vs its plain version on the card; returns its
    numbers at the fleet path's shape."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    cases = [("main", *k1_inputs(rng, N_PEERS, 125))]
    for k in (1, 7, 300):
        for P in (1, 125, 257):
            cases.append((f"ragged_{k}x{P}", *k1_inputs(rng, k, P)))
    cand, avail, jitter = k1_inputs(rng, 300, 125)
    cand[::3] = False
    cases.append(("all_masked_rows", cand, avail, jitter))
    cases.append(("forced_ties", *k1_inputs(
        rng, 1000, 257, density=0.8, avail_lo=3, avail_hi=4, quantized=True)))
    cases.append(("avail_near_2^24", *k1_inputs(
        rng, 1000, 125, avail_lo=(1 << 24) - 4, avail_hi=1 << 24,
        quantized=True)))
    # rows too wide for a staged tile of 32, read from device memory
    cases.append(("wide_8_rows", *k1_inputs(rng, 37, 700)))
    cases.append(("wide_unstaged", *k1_inputs(rng, 37, 1500)))
    worst = 0
    main = None
    for name, cand, avail, jitter in cases:
        c = torch.from_numpy(cand).to(dev)
        a = torch.from_numpy(avail).to(dev)
        j = torch.from_numpy(jitter).to(dev)
        got = kernels.rarest_argmin_cuda(c, a, j)
        want = kernels.rarest_argmin_ref(c, a, j)
        if not torch.equal(got, want):
            fail(f"K1 dense {name}: {int((got != want).sum())} picks differ "
                 "from the plain version")
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        if name == "main":
            main = (c, a, j)
        log(f"K1 dense {name} {tuple(cand.shape)}: index-exact")
    c, a, j = main
    k, P = c.shape
    ms = median_ms(lambda: kernels.rarest_argmin_cuda(c, a, j), reps=20)
    plain_ms = median_ms(lambda: kernels.rarest_argmin_ref(c, a, j), reps=5)
    # each input read once, the picks written once; two float32 compares
    # (availability, then jitter) per candidate
    bound_ms, bound_by = bound(k * P * (1 + 4) + 4 * P + 4 * k,
                               2 * int(c.sum()))
    return worst, {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "shape": [k, P],
    }


# the stream rules of the gathered form: (stream, mode, fallback)
STREAM_RULES = [("http", "swarm_first", True), ("http", "swarm_first", False),
                ("http", "http_first", False), ("swarm", "swarm_first", True)]


def gathered_state(kernels, rng, n, P, dev):
    """A fleet state from a numpy seed with the gathered form's edge cases
    in it: row 1 holds every piece, rows 2 and 3 miss one piece each (1
    and 5: ``gathered_rows`` may hand either to the other stream), a
    quarter of the jitter rows quantized (ties down to the piece index),
    replica counts at 0 (pieces 0-2) and near ``n``."""
    import numpy as np

    jitter = rng.random((n, P), dtype=np.float32)
    jitter[: n // 4] = rng.integers(0, 3, (n // 4, P)) / 4.0
    swarm_class = rng.random(P) < 0.6
    swarm_class[:2] = [True, False]
    have = rng.random((n, P)) < 0.5
    have[1] = True
    have[2] = True
    have[2, 1] = False
    have[3] = True
    have[3, 5] = False
    repl = have.sum(axis=0)
    repl[3::4] = n - 1 - np.arange(repl[3::4].size) % 3
    repl[5] = n - 2
    repl[:3] = 0
    return kernels.FleetDeviceState.from_arrays(
        have, jitter, repl, swarm_class, device=dev)


def gathered_rows(rng, n, P, k, dev):
    """``k`` rows with repeats (rows 1-3 among them) and their ``other``:
    -1, a random piece, or the row's only candidate."""
    import numpy as np
    import torch

    rows = rng.integers(0, n, k)
    rows[: min(k, 3)] = [1, 2, 3][: min(k, 3)]
    other = np.where(rng.random(k) < 0.5, rng.integers(0, P, k), -1)
    for row, only in ((2, 1), (3, 5)):
        at = rows == row
        other[at] = np.where(rng.random(int(at.sum())) < 0.5, only, -1)
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(other).to(dev))


def check_k1(kernels, dev):
    """K1 vs its plain versions on the card, both forms; returns the
    kernel's record (the gathered form's numbers: the fleet path's)."""
    import numpy as np
    import torch

    from repro_torch.kernels.swarm import ref

    worst, dense = check_k1_dense(kernels, dev)
    rng = np.random.default_rng(17)
    for n, P in ((N_PEERS, 125), (20_000, 257)):
        st = gathered_state(kernels, rng, n, P, dev)
        state = (st.have, st.jitter, st.repl, st.swarm_class)
        for k in (1, 7, 300, n):
            r, o = gathered_rows(rng, n, P, k, dev)
            for stream, mode, fallback in STREAM_RULES:
                kw = dict(stream=stream, mode=mode, fallback=fallback)
                got = kernels.select_rows_cuda(*state, r, o, **kw)
                want = kernels.select_rows_ref(*state, r, o, **kw)
                what = f"K1 gathered n={n} P={P} k={k} {stream}/{mode}" \
                    f"/{fallback}"
                if not torch.equal(got, want):
                    fail(f"{what}: {int((got != want).sum())} picks differ "
                         "from the plain version")
                held_all = got[r == 1]
                only_gone = got[((r == 2) & (o == 1)) | ((r == 3) & (o == 5))]
                if (held_all != -1).any() or (only_gone != -1).any():
                    fail(f"{what}: a row with no candidate picked a piece")
                worst = max(worst, int((got.long() - want.long()).abs().max()))
            log(f"K1 gathered n={n} P={P} (pitch {st.pitch}) k={k}: "
                "index-exact on the four stream rules")
        if n != N_PEERS:
            continue
        # the fleet path's shape: every row of a 10^6-peer state once
        r = torch.randperm(n, device=dev)
        o = torch.from_numpy(np.where(
            rng.random(n) < 0.5, rng.integers(0, P, n), -1)).to(dev)
        kw = dict(zip(("stream", "mode", "fallback"), STREAM_RULES[0]))
        ms = median_ms(lambda: kernels.select_rows_cuda(*state, r, o, **kw),
                       reps=20)
        plain_ms = median_ms(
            lambda: kernels.select_rows_ref(*state, r, o, **kw), reps=5)
        # the replaced design: the candidates built by torch ops, then the
        # dense form
        with swapped(ref, "rarest_argmin_ref", kernels.rarest_argmin_cuda):
            control = kernels.select_rows_ref(*state, r, o, **kw)
            control_ms = median_ms(
                lambda: kernels.select_rows_ref(*state, r, o, **kw), reps=5)
        if not torch.equal(control, kernels.select_rows_cuda(*state, r, o,
                                                             **kw)):
            fail("K1 gathered: the replaced design picks otherwise")
        # what the wrapper's device-side range check (one synchronisation)
        # adds to a small call, against ranges checked on the host as
        # FleetDeviceState.select does
        r3, o3 = gathered_rows(rng, n, P, 300, dev)
        range_check = {
            f"{where}_ms": median_ms(
                lambda c=checked: kernels.select_rows_cuda(
                    *state, r3, o3, ranges_checked=c, **kw), reps=20)
            for where, checked in (("device", False), ("host", True))}
        k = r.numel()
        rows_read = int(torch.unique(r).numel())
        # the rows read once (a have byte and a jitter float a piece), rows,
        # other and the picks, the (P,) counts and classes; one candidate
        # test and one compare a piece
        bound_ms, bound_by = bound(rows_read * P * 5 + k * (8 + 8 + 4)
                                   + P * 5, 2 * k * P, I32_OPS_PER_S)
        shape = [k, n, P]
        del st, state
        torch.cuda.empty_cache()
    log(f"K1 gathered at k={shape[0]} of n={shape[1]}: {ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}), plain {plain_ms:.3f} ms, the "
        f"replaced torch build + dense form {control_ms:.3f} ms; dense "
        f"form at {dense['shape']}: {dense['ms']:.3f} ms, bound "
        f"{dense['bound_ms']:.3f} ms, plain {dense['plain_ms']:.3f} ms; at "
        f"k=300 the device range check {range_check['device_ms']:.4f} ms a "
        f"call, ranges checked on the host {range_check['host_ms']:.4f} ms")
    return {
        "name": "rarest_argmin",
        "route": "cuda",
        "source": SWARM_SOURCE,
        "replaces": "src/repro/kernels/swarm/kernel.py:64",
        "max_abs_err": worst,
        "matched": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "form": "gathered",
        "shape": shape,
        "control_ms": control_ms,
        "range_check_k300": range_check,
        "dense": dense,
    }


# ------------------------------------------------------------------ fleet path


def run_main_path(kernels, n=N_PEERS, dt=DT, golden_row=GOLDEN_ROW,
                  device=None):
    """The flash crowd through the port's scenario entry point, as a user
    calls it: the committed file with ``n`` and ``dt`` replaced, on
    ``device`` (None = the CUDA card)."""
    import numpy as np
    import torch

    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.kernels.swarm import ops

    spec = ScenarioSpec.load(SCENARIO)
    spec = dataclasses.replace(
        spec,
        arrivals=(dataclasses.replace(spec.arrivals[0], n=n),),
        fleet=dataclasses.replace(spec.fleet, dt=dt),
    )
    compiled = spec.build("fleet", device=device)
    sim = next(iter(compiled.sims.values()))
    # keep the flow tables the engine water-fills, for phase 5: references
    # only (the engine builds fresh arrays every tick and never writes them
    # after the call), so the timed run carries no copies
    tables = {}
    sim._freeze()
    inner = sim._waterfill_dev

    def capture(fsrc, fdst, up_cap, down_cap, link_of=None, link_cap=None):
        table = (fsrc, fdst, up_cap, down_cap, link_of, link_cap)
        tables.setdefault("first", table)
        if fsrc.size > tables.get("largest", (np.zeros(0),))[0].size:
            tables["largest"] = table
        return inner(fsrc, fdst, up_cap, down_cap, link_of, link_cap)

    sim._waterfill_dev = capture
    # split the waterfill phase: the seconds inside the K2 dispatch (input
    # checks and the fixed point, which ends on a host synchronisation)
    # against the host's table build, upload and download around it
    dispatch = ops.waterfill
    k2_seconds = []

    def timed_waterfill(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dispatch(*args)
        torch.cuda.synchronize()
        k2_seconds.append(time.perf_counter() - t)
        return out

    # the same for the selection: the seconds inside the K1 dispatch (input
    # checks and the gathered form), against the host's row masks, index
    # uploads and pick downloads around it
    select_dispatch = ops.select_rows
    k1_seconds = []

    def timed_select(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = select_dispatch(*args, **kw)
        torch.cuda.synchronize()
        k1_seconds.append(time.perf_counter() - t)
        return out

    ops.waterfill = timed_waterfill
    ops.select_rows = timed_select
    kernels.rarest_argmin_cuda.launches = 0
    kernels.select_rows_cuda.launches = 0
    kernels.waterfill_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        res = compiled.run().primary
    finally:
        ops.waterfill = dispatch
        ops.select_rows = select_dispatch
    wall = time.perf_counter() - t0
    by_form = {"dense": kernels.rarest_argmin_cuda.launches,
               "gathered": kernels.select_rows_cuda.launches}
    launches = {
        "rarest_argmin": sum(by_form.values()),
        "waterfill": kernels.waterfill_cuda.launches,
    }

    done = np.isfinite(res.completed_at)
    t_all = float(res.completed_at[done].max())
    size = spec.content.manifests[0].size_bytes
    copies = res.origin_uploaded / size
    golden = next(r for r in json.loads(GOLDENS.read_text())["rows"]
                  if r["name"] == golden_row)["derived"]
    g_tall = float(re.search(r"t_all=([0-9.]+)s", golden).group(1))
    log(f"fleet path: n={res.n} dt={res.dt} ticks={res.ticks} "
        f"t_all={t_all:.0f}s copies={copies:.2f} ud={res.ud_ratio:.1f} "
        f"done={int(done.sum())}/{res.n} wall={wall:.1f}s "
        f"us_per_client_tick={wall * 1e6 / (res.n * res.ticks):.3f}")
    log(f"fleet path golden ({golden_row}, float64 numpy): {golden}")
    log("fleet path phase_seconds: " + json.dumps(res.phase_seconds))
    k2_in_run = sum(k2_seconds)
    log(f"fleet path waterfill phase split: {k2_in_run:.3f}s in the K2 "
        f"dispatch over {len(k2_seconds)} calls, "
        f"{res.phase_seconds['waterfill'] - k2_in_run:.3f}s host table "
        "build, upload and download")
    k1_in_run = sum(k1_seconds)
    log(f"fleet path select phase split: {k1_in_run:.3f}s in the K1 "
        f"dispatch over {len(k1_seconds)} calls, "
        f"{res.phase_seconds['select'] - k1_in_run:.3f}s host row masks, "
        "index upload and pick download")
    log(f"fleet path launches: {json.dumps(launches)}, K1 by form "
        f"{json.dumps(by_form)}")
    if by_form["dense"]:
        fail(f"the fleet path's selection launched K1's dense form "
             f"{by_form['dense']} times")
    if by_form["gathered"] != len(k1_seconds):
        fail(f"{len(k1_seconds)} selections on the fleet path, "
             f"{by_form['gathered']} launches of K1's gathered form")
    if int(done.sum()) != n:
        fail(f"only {int(done.sum())}/{n} peers completed")
    band = max(5 * dt, 0.03 * g_tall)
    if abs(t_all - g_tall) > band:
        fail(f"t_all={t_all}s is outside {g_tall}s +- {band}s")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the fleet path never launched the {name} kernel")
    return launches, by_form, tables, {
        "ticks": res.ticks, "t_all": t_all, "copies": copies, "wall_s": wall,
        "phase_seconds": res.phase_seconds, "k1_dispatch_s": k1_in_run,
        "k1_calls": len(k1_seconds), "k2_dispatch_s": k2_in_run,
        "k2_calls": len(k2_seconds),
    }


# ------------------------------------------------------------------ K2


def random_topology(rng, nf, nn, spine, inf_caps):
    import numpy as np

    src = rng.integers(0, nn, nf)
    dst = rng.integers(0, nn, nf)
    dst = np.where(dst == src, (dst + 1) % nn, dst)
    up = rng.uniform(1.0, 100.0, nn)
    dn = rng.uniform(1.0, 100.0, nn)
    if inf_caps:
        dn[rng.random(nn) < 0.3] = np.inf
    link_of = link_cap = None
    if spine:
        link_of = np.where(rng.random(nf) < 0.5, 0, -1).astype(np.int64)
        link_cap = np.array([rng.uniform(5.0, 60.0)])
    return src, dst, up, dn, link_of, link_cap


def k2_compare(kernels, args, what):
    """K2 and its plain version on one flow table: rates, rounds and each
    round's active-flow count must agree exactly, and each round's touched
    slots must be those of the compacted plain statement. Returns the
    kernel's rates, its active and touched counts and the largest rate
    difference."""
    import torch

    act_got, act_want, touched, touched_want = [], [], [], []
    got, r_got = kernels.waterfill_cuda(*args, active_counts=act_got,
                                        touched_counts=touched)
    want, r_want = kernels.waterfill_ref(*args, active_counts=act_want)
    if not torch.equal(got, want) or (r_got, act_got) != (r_want, act_want):
        diff = float((got - want).abs().max())
        fail(f"K2 {what}: max |diff| {diff}, rounds {r_got} vs {r_want}, "
             f"active per round {act_got} vs {act_want}")
    kernels.waterfill_compact_ref(*args, touched_counts=touched_want)
    if touched != touched_want:
        fail(f"K2 {what}: touched slots per round {touched} vs "
             f"{touched_want}")
    return got, act_got, touched, float((got - want).abs().max())


def k2_device_ops(kernels, args, dev):
    """The device operations of one ``waterfill_cuda`` call on ``args``, as
    torch.profiler's CUDA trace records them: ``{name: count}``, K2's own
    kernel under ``"waterfill_kernel"``. None on the host (no trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.device(dev).type != "cuda":
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kernels.waterfill_cuda(*args)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = ("waterfill_kernel" if "waterfill_kernel" in e.name
                    else e.name[:80])
            ops[name] = ops.get(name, 0) + 1
    return ops


def check_k2(kernels, dev, tables):
    """K2 vs its plain version on the card; returns the kernel's record."""
    import numpy as np

    from repro_torch.core.fleet import waterfill_rates

    worst = 0.0
    rng = np.random.default_rng(12)
    for trial in range(24):
        nf = int(rng.integers(1, 2001))
        nn = int(rng.integers(2, 201))
        table = random_topology(rng, nf, nn, spine=trial % 2 == 1,
                                inf_caps=trial % 3 == 0)
        args = kernels.flow_table(*table, device=dev)
        got, _, _, err = k2_compare(
            kernels, args, f"random topology {trial} (nf={nf}, nn={nn})")
        worst = max(worst, err)
        f64 = waterfill_rates(*table)
        np.testing.assert_allclose(got.cpu().numpy(), f64, rtol=1e-3,
                                   atol=1e-3)
    log("K2 random topologies (24, nf<=2000, nn<=200, spine, inf caps): "
        "bit-exact, within 1e-3 of float64")
    for name in ("first", "largest"):
        args = kernels.flow_table(*tables[name], device=dev)
        _, active, touched, err = k2_compare(
            kernels, args, f"main-path table {name}")
        worst = max(worst, err)
        log(f"K2 main-path table {name} (nf={args[0].numel()}, "
            f"nodes={args[3].numel()}): bit-exact, {len(active)} rounds in "
            f"one launch of {kernels.waterfill_cuda.last_grid} CTAs, active "
            f"flows per round {active}, touched slots per round {touched}")
    nf, nn, nlp = args[0].numel(), args[3].numel(), args[5].numel()
    ncon = 2 * nn + nlp
    # what one call at the largest table ran on the card, from the trace
    device_ops = k2_device_ops(kernels, args, dev)
    if device_ops is None:
        per_call = None
        log("K2 device operations a call: not measured on the host")
    else:
        per_call = {"waterfill_kernel": device_ops.pop("waterfill_kernel", 0),
                    "other": sum(device_ops.values())}
        log(f"K2 device operations of one call at the largest table (torch."
            f"profiler): waterfill_kernel {per_call['waterfill_kernel']}, "
            f"others {json.dumps(device_ops)}")
        if per_call["waterfill_kernel"] != 1:
            fail(f"K2: one call launched waterfill_kernel "
                 f"{per_call['waterfill_kernel']} times, not once")
    ms = median_ms(lambda: kernels.waterfill_cuda(*args), reps=5)
    plain_ms = median_ms(lambda: kernels.waterfill_ref(*args), reps=3)
    # Each input read once (src/dst/lnk, the capacities), the rates
    # written once. Float32 operations of this table's rounds: per active
    # flow a rate add and three saturation compares, per constraint slot a
    # subtract, a divide, a min, a multiply and an add.
    bound_ms, bound_by = bound(
        nf * (12 + 4) + ncon * 4, sum(4 * a + 5 * ncon for a in active)
    )
    # The round-by-round bound of the compacted design: a round reads the
    # indices and rate of its active flows (12 + 4 B) and, for each slot
    # they touch, its capacity, allocation and count (12 B). Beside it the
    # bound of the replaced full-table design: every flow's frozen flag and
    # three 4-byte vectors for every slot, each round.
    round_bound_ms = sum(
        16 * a + 12 * s for a, s in zip(active, touched)
    ) / HBM_BYTES_PER_S * 1e3
    table_round_bound_ms = sum(
        nf + 16 * a + 12 * ncon for a in active
    ) / HBM_BYTES_PER_S * 1e3
    return {
        "name": "waterfill",
        "route": "cuda",
        "source": SWARM_SOURCE,
        "replaces": "src/repro/kernels/swarm/kernel.py:145",
        "max_abs_err": worst,
        "matched": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [nf, nn, nlp],
        "rounds": len(active),
        "active_per_round": active,
        "touched_per_round": touched,
        "round_bound_ms": round_bound_ms,
        "table_round_bound_ms": table_round_bound_ms,
        # device operations of one call, read from the profiler's trace:
        # K2's kernel, and the rest (input checks, the scratch's zero-fill,
        # the copies of the rounds back)
        "launches_per_call": per_call,
        "grid": kernels.waterfill_cuda.last_grid,
    }


# ------------------------------------------------------------------ K3


def k3_inputs(rng, dtype, n):
    """``n`` elements of ``dtype`` from ``rng``, spanning the dtype's
    range (negative integers, float specials) on the host."""
    import numpy as np
    import torch

    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype.is_floating_point:
        x = rng.normal(scale=1e3, size=n)
        specials = [0.0, -0.0, np.inf, -np.inf, 1e-42, 6e-8, 1e300, -1e-300]
        x[: min(n, len(specials))] = specials[:n]
        if dtype == torch.float32 and n > len(specials):
            x[len(specials)] = np.nan
        return torch.from_numpy(x).to(dtype)
    info = torch.iinfo(dtype)
    bits = torch.from_numpy(rng.bit_generator.random_raw(n).view(np.int64))
    if info.bits == 64:
        return bits.view(dtype)
    return (bits % (1 << info.bits) + info.min).to(dtype)


def check_k3(kernels, dev):
    """K3 vs its plain version on the card, exact, on small and awkward
    inputs (the full-size bundle is checked on the broadcast path)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)
    cases = []
    for dtype in kernels.ref.DTYPES:
        for n in (1, 2, 3, 4, 5, 6, 7, 2048, 2048 * 5 + 3, 100_003):
            cases.append((f"{dtype} n={n}", k3_inputs(rng, dtype, n), 2048))
    for dtype in (torch.uint8, torch.int32, torch.float16):
        cases.append((f"{dtype} n=b=512", k3_inputs(rng, dtype, 512), 512))
        cases.append((f"{dtype} n=4096 block=512",
                      k3_inputs(rng, dtype, 4096), 512))
        cases.append((f"{dtype} ragged block=512",
                      k3_inputs(rng, dtype, 512 * 7 + 100), 512))
    # blocks past 32768 words take the kernel's wrapping path; at 2*10^5
    # words of full-range uint32 the reference's uint32 sums do wrap
    cases.append(("uint32 block=200000 (sums wrap)",
                  k3_inputs(rng, torch.uint32, 450_000), 200_000))
    cases.append(("int8 block=40000", k3_inputs(rng, torch.int8, 90_001),
                  40_000))
    cases.append(("uint8 n=b=32768", k3_inputs(rng, torch.uint8, 32768),
                  32768))
    big = k3_inputs(rng, torch.uint8, 1 << 20)
    cases.append(("uint8 misaligned view", big[1:], 2048))
    cases.append(("float64 misaligned view",
                  k3_inputs(rng, torch.float64, 10_000)[3:], 2048))
    for name, x, block in cases:
        x = x.to(dev)
        b = min(block, max(x.numel(), 8))
        got = kernels.checksum_cuda(x, b)
        want = kernels.checksum_ref(x, b)
        if not torch.equal(got, want):
            fail(f"K3 {name}: {got.tolist()} vs plain {want.tolist()}")
    torch.cuda.synchronize()
    log(f"K3 {len(cases)} cases (every dtype, n=1..7, n=b, ragged n, "
        "block=512, wrapping blocks, misaligned views): exact")


# ------------------------------------------------------------------ broadcast


def run_broadcast_path(kernels, nbytes=BUNDLE_BYTES, device=None):
    """Stage 2 of the checkpoint broadcast example on a ``nbytes`` bundle
    through a one-rank group on ``device`` (None = the CUDA card, over
    NCCL), with its checks; returns K3's record and the path's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.collective_fabric import (
        allgather_bundle, local_stripe, single_rank_group,
    )
    from repro_torch.examples.checkpoint_broadcast import (
        collective_stage, make_bundle, replica_matches,
    )

    t0 = time.perf_counter()
    payload = make_bundle(nbytes, BUNDLE_SEED)
    log(f"broadcast path: {nbytes} byte bundle from seed {BUNDLE_SEED} in "
        f"{time.perf_counter() - t0:.1f}s")
    group = single_rank_group(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.checksum_cuda.launches = 0
    t0 = time.perf_counter()
    rep = collective_stage(payload, group, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.checksum_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"broadcast path: {rep.length} bytes over "
        f"{dist.get_world_size(group)} rank(s), replica "
        f"{tuple(rep.replicated.shape)}, checksum {rep.checksum.tolist()}, "
        f"replicas agree {rep.agree}, wall {wall:.2f}s, K3 launches "
        f"{launches}, peak device memory {peak / 2**30:.2f} GiB")
    if not rep.agree:
        fail("verify_replicas found the ranks' checksums unequal")
    if launches <= 0:
        fail("the broadcast path never launched the checksum kernel")
    if not replica_matches(rep.replicated, payload):
        fail("the replicated bundle differs from the payload")
    log("broadcast path: replica equals the payload byte for byte")
    flat = rep.replicated.view(-1)
    before = kernels.device_checksum(rep.stripe)
    if not torch.equal(before, rep.checksum):
        fail(f"replica checksum {rep.checksum.tolist()} differs from the "
             f"stripes' {before.tolist()} taken before the gather")
    plain = kernels.checksum_ref(flat, 2048)
    if not torch.equal(plain, rep.checksum):
        fail(f"K3 {rep.checksum.tolist()} differs from its plain version "
             f"{plain.tolist()} on the {flat.numel()}-element bundle")
    log("broadcast path: checksum equals the stripes' and the plain "
        "version's")
    flip = flat[FLIP_AT:FLIP_AT + 1]
    flip.bitwise_xor_(1)
    bad = kernels.device_checksum(rep.replicated)
    if torch.equal(bad, rep.checksum) or kernels.verify_replicas(
            [rep.checksum, bad]):
        fail(f"a bit flipped at index {FLIP_AT} went undetected")
    flip.bitwise_xor_(1)
    log(f"broadcast path: bit flipped at index {FLIP_AT} detected "
        f"({rep.checksum.tolist()} -> {bad.tolist()})")

    ms = median_ms(lambda: kernels.checksum_cuda(flat, 2048), reps=10)
    plain_ms = median_ms(lambda: kernels.checksum_ref(flat, 2048), reps=3)
    gather_ms = median_ms(lambda: allgather_bundle(rep.stripe, group),
                          reps=3)
    # the stage's host-to-device copy of this rank's stripe, alone
    t0 = time.perf_counter()
    local_stripe(payload, group, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    n = flat.numel()
    # the bundle read once and (S1, S2) written once; an add and a
    # multiply-add for each element
    bound_ms, bound_by = bound(n * flat.element_size() + 16, 2 * n,
                               I32_OPS_PER_S)
    dist.destroy_process_group()
    return {
        "name": "checksum",
        "route": "cuda",
        "source": CHECKSUM_SOURCE,
        "replaces": "src/repro/kernels/checksum/kernel.py:26",
        "launches": launches,
        "max_abs_err": 0,
        "matched": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": [n],
        "dtype": str(flat.dtype),
    }, {
        "bytes": n, "wall_s": wall, "stripe_upload_s": upload_s,
        "allgather_ms": gather_ms, "peak_gib": peak / 2**30,
    }


# ------------------------------------------------------------------ K4


def live_pairs(sq: int, skv: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """The (q, k) pairs that K4's masks let through (every key valid),
    query row ``i`` the global row ``q_offset + i``."""
    import numpy as np

    q = q_offset + np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= q >= k
    if window > 0:
        mask &= q - k < window
    return int(mask.sum())


def tolerance_share(got, want, atol=1e-4, rtol=1e-4) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the elements:
    how much of ``torch.isclose``'s allowance the worst one takes (above 1
    it falls outside)."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float32."""
    import torch

    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).norm() / want.norm())


def live_mask(sq, skv, *, causal=True, window=0, q_offset=0,
              skv_valid=None, device=None):
    """The (Sq, Skv) boolean mask of the (q, k) pairs that K4's masks let
    through, query row ``i`` the global row ``q_offset + i``: the plain
    version's, and ``scaled_dot_product_attention``'s ``attn_mask``."""
    import torch

    qi = q_offset + torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    mask = (ki < (skv if skv_valid is None else skv_valid)).expand(sq, skv)
    if causal:
        mask = mask & (qi >= ki)
    if window > 0:
        mask = mask & (qi - ki < window)
    return mask


def attention_scores(q, k, *, causal=True, window=0, softcap=0.0,
                     skv_valid=None, q_offset=0):
    """The plain version's scaled (and soft-capped) float32 scores (B, Hkv,
    Hq / Hkv, Sq, Skv) and its mask of live (q, k) pairs (Sq, Skv), query
    row ``i`` the global row ``q_offset + i``."""
    import math

    import torch

    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, sq, d) / math.sqrt(d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(torch.float32))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s, live_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, skv_valid=skv_valid,
                        device=q.device)


def attention_bf16_probs(q, k, v, *, causal=True, window=0, softcap=0.0,
                         skv_valid=None, q_offset=0, split=False):
    """The lower-precision control for K4's bands: the plain version with
    its probabilities rounded to bfloat16 before P·V, as a kernel that
    feeds bf16 P to the tensor cores computes; with ``split``, as K4's
    tensor-core kernel splits them instead, bf16(p) + bf16(p - bf16(p)).
    Same contract and layout as ``attention_bhsd_ref``."""
    import torch

    b, hq, sq, d = q.shape
    s, mask = attention_scores(q, k, causal=causal, window=window,
                               softcap=softcap, skv_valid=skv_valid,
                               q_offset=q_offset)
    p = torch.softmax(s.masked_fill(~mask, -2e38), dim=-1)
    hi = p.to(torch.bfloat16).to(torch.float32)
    p = hi + (p - hi).to(torch.bfloat16).to(torch.float32) if split else hi
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_widened(q, k, v, **kw):
    """K4 as the bf16 design it replaced computed it: the float32 SIMT
    kernel on q, k, v widened to float32, its output rounded to q's
    dtype."""
    import torch

    from repro_torch.kernels.attention import flash_attention_cuda

    return flash_attention_cuda(*(t.to(torch.float32) for t in (q, k, v)),
                                **kw).to(q.dtype)


@contextlib.contextmanager
def sequence_attention(fn):
    """Run the model's sequence attention through ``fn`` in K4's place
    (the dispatch in ``kernels/attention/ops.py`` calls it for CUDA
    tensors)."""
    from repro_torch.kernels.attention import ops

    kernel = ops.flash_attention_cuda
    ops.flash_attention_cuda = fn
    try:
        yield
    finally:
        ops.flash_attention_cuda = kernel


def by_route(counts) -> dict:
    """A kernel's launch counts ((dtype, route) -> launches, as the
    wrapper's ``route_launches`` holds them) as {"dtype/route": launches}."""
    return {f"{dt}/{route}": n for (dt, route), n in sorted(counts.items())}


def check_routes(kernel, counts, paths):
    """Fail unless every launch of ``kernel`` (K4, K4b or K5) in the run
    (``counts``, the wrapper's ``route_launches``) took the route of its
    dtype (``DTYPE_ROUTE``), as the launch that ran reported it, and each
    path's launches by route (``paths``: path -> ({"dtype/route": n},
    launches)) add up to its launch count; returns the run's as
    {"dtype/route": launches}."""
    routes = by_route(counts)
    wrong = {key: n for key, n in routes.items()
             if DTYPE_ROUTE.get(key.split("/")[0]) != key.split("/")[1]}
    if wrong:
        fail(f"{kernel}: launches on the wrong route {wrong} (each dtype "
             f"must take {DTYPE_ROUTE})")
    for arch, (path_routes, launches) in paths.items():
        if sum(path_routes.values()) != launches:
            fail(f"{kernel} on the {arch} path: {path_routes} by "
                 f"route, {launches} launches")
    log(f"{kernel} launches by route: the whole run {routes}; paths "
        + json.dumps({arch: r for arch, (r, _) in paths.items()}))
    return routes


def check_k4_ptxas(report: str, head_dims) -> tuple[dict, dict]:
    """Registers and spilled bytes of each K4 and K4b kernel instance from
    ``-Xptxas -v``'s ``report`` of the attention source, as ({"route d":
    [registers, spill bytes]}, {"kernel dtype d": [...]}) for the forward
    and the backward (the forward in two instances, the one training runs
    writing lse; the backward's SIMT kernels in both dtypes, the bfloat16
    ones being the control that the tensor-core route replaced, and its
    tensor-core dK/dV and dQ kernels, "tensor_core"); fails if any
    instance spills (the tensor-core kernels' accumulators alone are 128
    registers a thread at d 256) or one is missing."""
    routes = {"tc": "tensor_core", "simt": "simt"}
    dtypes = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
    fwd, bwd, row = {}, {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            row = None
            if m := re.search(r"\d(tc|simt)15attn_fwd_kernelILi(\d+)ELb([01])E",
                              line):
                lse = " lse" if m.group(3) == "1" else ""
                row = fwd[f"{routes[m.group(1)]} d{m.group(2)}{lse}"] = [0, 0]
            elif m := re.search(r"3bwd\d+(delta|dkdv|dq)_kernelI"
                                r"(f|13__nv_bfloat16)Li(\d+)E", line):
                row = bwd[f"{m.group(1)} {dtypes[m.group(2)]} "
                          f"d{m.group(3)}"] = [0, 0]
            elif m := re.search(r"3bwd2tc\d+(dkdv|dq)_kernelILi(\d+)E",
                                line):
                row = bwd[f"{m.group(1)} tensor_core d{m.group(2)}"] = [0, 0]
        elif row is not None and (m := re.search(r"Used (\d+) registers",
                                                 line)):
            row[0] = int(m.group(1))
        elif row is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            row[1] = int(m.group(1)) + int(m.group(2))
    if len(fwd) != 4 * len(head_dims) or len(bwd) != 8 * len(head_dims):
        fail(f"K4 -Xptxas -v: {sorted(fwd)} forward and {sorted(bwd)} "
             f"backward kernel instances; two a route and head dim "
             f"{head_dims} (with and without lse), and for the backward "
             f"three a dtype and head dim (SIMT) and two a head dim (tensor "
             f"cores), expected:\n{report}")
    spills = {n: v[1] for n, v in {**fwd, **bwd}.items() if v[1]}
    if spills:
        fail(f"K4 -Xptxas -v: spilled bytes {spills}")
    log("K4 -Xptxas -v, registers a thread, no spill: "
        + ", ".join(f"{n} {v[0]}" for n, v in fwd.items()))
    log("K4b -Xptxas -v, registers a thread, no spill: "
        + ", ".join(f"{n} {v[0]}" for n, v in bwd.items()))
    return fwd, bwd


# each kernel of a source as -Xptxas -v names it (a part of its mangled
# name) -> its label in the log and the record
SWARM_KERNELS = {"rarest_dense_kernelILb1E": "K1 dense, 32 staged rows a CTA",
                 "rarest_dense_kernelILb0E": "K1 dense, a warp a row",
                 "rarest_gathered_kernel": "K1 gathered",
                 "waterfill_kernel": "K2 persistent"}
K5_KERNELS = {"tc12chunk_kernel": "tensor_core",
              "simt16ssd_chunk_kernel": "simt"}
K6_KERNELS = {"17rglru_scan_kernel": "ring"}


def check_ptxas(what: str, report: str, kernels: dict) -> dict:
    """Registers, spilled bytes and static shared memory of each kernel
    of ``kernels`` (a part of its mangled name -> label) from ``-Xptxas
    -v``'s ``report`` of one source, as {label: [registers, spill bytes,
    static shared memory bytes]}; fails unless the source holds exactly
    those kernels, or if any of them spills."""
    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((v for key, v in kernels.items()
                         if key in m.group(1)), m.group(1))
            found[name] = [0, 0, 0]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found[name][0] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                found[name][2] = int(sm.group(1))
        elif name and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            found[name][1] = int(m.group(1)) + int(m.group(2))
    if sorted(found) != sorted(kernels.values()):
        fail(f"{what} -Xptxas -v: kernels {sorted(found)}, expected "
             f"{sorted(kernels.values())}:\n{report}")
    spills = {n: v[1] for n, v in found.items() if v[1]}
    if spills:
        fail(f"{what} -Xptxas -v: spilled bytes {spills}")
    log(f"{what} -Xptxas -v, no spill; registers a thread (static shared "
        "memory bytes): " + ", ".join(f"{n} {v[0]} ({v[2]})"
                                      for n, v in found.items()))
    return found


def k4_bound(q, k, *, window, causal=True, q_offset=0):
    """K4's bound at bf16 q (B, Hq, Sq, d) and k/v (B, Hkv, Skv, d): q, k,
    v read once and the output written once; 4·d operations per live (q,
    k) pair and query head (q·k and p·v; the pairs counted with the query
    offset), at the bf16 tensor-core rate. Returns (ms, bound_by,
    operations)."""
    b, hq, sq, d = q.shape
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4 * b * hq * d * live_pairs(sq, k.shape[2], causal, window,
                                        q_offset)
    return (*bound(nbytes, flops, BF16_TENSOR_OPS_PER_S), flops)


def check_k4(k4, dev):
    """K4 vs its plain version on the card at the reference's five cases,
    masked keys, scores in the softcap's bend and the serving prefill
    shape; returns the kernel's record."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def qkv(b, sq, skv, hq, hkv, d, dtype, q_scale=1.0):
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        return q.mul_(q_scale).to(dtype), k.to(dtype), v.to(dtype)

    worst = 0.0

    def compare(what, got, want):
        nonlocal worst
        atol, rtol = K4_TOL[str(got.dtype)[6:]]
        got, want = got.to(f32), want.to(f32)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bad = ~torch.isclose(got, want, atol=atol, rtol=rtol)
        if not torch.isfinite(got).all() or bool(bad.any()):
            fail(f"K4 {what}: {int(bad.sum())} values outside atol {atol} "
                 f"rtol {rtol} of the plain version (max |diff| {err})")
        worst = max(worst, err)
        log(f"K4 {what}: max |diff| {err:.3g} within atol {atol:.3g} "
            f"rtol {rtol:.3g}")

    # (case, dtype, q scale, skv_valid)
    cases = [(c, dtype, 1.0, None) for dtype in (f32, bf16) for c in K4_CASES]
    for dtype in (f32, bf16):
        # keys at or past skv_valid masked, in a full and a ragged tile
        cases.append((K4_CASES[3], dtype, 1.0, 250))
        cases.append((K4_CASES[4], dtype, 1.0, 77))
        # q x 8: scores of std 8 reach into the softcap's bend (50 tanh(s
        # / 50) is 15 % below s at s = 40)
        cases.append(((1, 1024, 1024, 8, 4, 256, True, 512, 50.0), dtype,
                      8.0, None))
    for case, dtype, q_scale, skv_valid in cases:
        b, sq, skv, hq, hkv, d, causal, window, cap = case
        q, k, v = qkv(b, sq, skv, hq, hkv, d, dtype, q_scale)
        kw = dict(causal=causal, window=window, softcap=cap)
        what = (f"{str(dtype)[6:]} b={b} sq={sq} skv={skv} hq={hq} "
                f"hkv={hkv} d={d} causal={causal} window={window} "
                f"softcap={cap} q_scale={q_scale} skv_valid={skv_valid}")
        compare(what, k4.flash_attention_cuda(q, k, v, skv_valid=skv_valid,
                                              **kw),
                k4.attention_bhsd_ref(q, k, v, skv_valid=skv_valid, **kw))
        if skv_valid is None and q_scale == 1.0:
            # the public entry of the model's attention, on (B, S, H, D)
            # tensors laid out as the model's: the kernel reads them through
            # their strides and writes the output in the same layout
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            got = k4.flash_attention(qs, ks, vs, **kw)
            if not got.is_contiguous():
                fail(f"K4 {what} via ops.flash_attention: the output is not "
                     f"laid out (B, S, H, D) (strides {got.stride()})")
            compare(what + " via ops.flash_attention", got,
                    k4.attention_ref(qs, ks, vs, **kw))
            del qs, ks, vs, got
        del q, k, v

    # the serving prefill shapes, elementwise and in relative L2 against
    # K4_REL_L2, which must tell the bf16-probability control apart:
    # gemma2's global and local layers, and recurrentgemma's local layers,
    # as each path serves them (bf16) and in float32
    b, s, hq, hkv, d = 4, SERVE_PROMPT, 8, 4, 256
    prefill_cases = [((b, s, hq, hkv, d), bf16, window, 50.0)
                     for window in (0, 4096)]
    prefill_cases += [(K4_RECURRENTGEMMA, dtype, K4_RECURRENTGEMMA_WINDOW,
                       0.0) for dtype in (f32, bf16)]
    for shape, dtype, window, cap in prefill_cases:
        q, k, v = qkv(*shape[:2], *shape[1:], dtype)
        kw = dict(causal=True, window=window, softcap=cap)
        what = (f"prefill shape {shape} {str(dtype)[6:]} window {window} "
                f"softcap {cap}")
        got = k4.flash_attention_cuda(q, k, v, **kw)
        want = k4.attention_bhsd_ref(q, k, v, **kw)
        compare(what, got, want)
        rel = rel_l2(got, want)
        control = rel_l2(attention_bf16_probs(q, k, v, **kw), want)
        log(f"K4 {what}: relative L2 {rel:.4g} (band {K4_REL_L2:.4g}); "
            f"the bf16-probability control reads {control:.4g}")
        if rel > K4_REL_L2:
            fail(f"K4 {what}: relative L2 {rel} above {K4_REL_L2}")
        if control <= K4_REL_L2:
            fail(f"K4 {what}: the band {K4_REL_L2} does not tell the "
                 f"bf16-probability control ({control}) from the kernel")
        del q, k, v, got, want

    # timing at the serving prefill shape (a global layer: window 0)
    q, k, v = qkv(b, s, s, hq, hkv, d, bf16)
    kw = dict(causal=True, window=0, softcap=50.0)
    ms = median_ms(lambda: k4.flash_attention_cuda(q, k, v, **kw), reps=10)
    plain_ms = median_ms(lambda: k4.attention_bhsd_ref(q, k, v, **kw),
                         reps=3)
    # the library yardstick has no softcap: both timed at softcap 0, SDPA
    # on key/value heads expanded to the query heads outside the timing
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    nocap_ms = median_ms(lambda: k4.flash_attention_cuda(
        q, k, v, causal=True, window=0, softcap=0.0), reps=10)
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True), reps=10)
    del ke, ve
    # the float32 SIMT kernel on the same values: the arithmetic of the
    # bf16 design that the tensor-core kernel replaced (it widened bf16 to
    # float32 as it loaded), timed on this card
    q32, k32, v32 = (t.to(f32) for t in (q, k, v))
    simt_ms = median_ms(lambda: k4.flash_attention_cuda(q32, k32, v32, **kw),
                        reps=5)
    del q32, k32, v32
    bound_ms, bound_by, flops = k4_bound(q, k, window=0)
    log(f"K4 at the prefill shape: {ms:.3f} ms (softcap 0: {nocap_ms:.3f} "
        f"ms), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
        f"(softcap 0) {library_ms:.3f} ms, the float32 SIMT kernel "
        f"{simt_ms:.3f} ms ({simt_ms / ms:.2f}x), bound {bound_ms:.3f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved, "
        f"{100 * bound_ms / ms:.1f} % of the bound)")
    del q, k, v

    # timing at recurrentgemma's local-attention prefill, as served; the
    # library call takes the window as a boolean mask
    rb, rs, rhq, rhkv, rd = K4_RECURRENTGEMMA
    window = K4_RECURRENTGEMMA_WINDOW
    q, k, v = qkv(rb, rs, rs, rhq, rhkv, rd, bf16)
    kw = dict(causal=True, window=window, softcap=0.0)
    rg_ms = median_ms(lambda: k4.flash_attention_cuda(q, k, v, **kw),
                      reps=10)
    rg_plain_ms = median_ms(lambda: k4.attention_bhsd_ref(q, k, v, **kw),
                            reps=3)
    ke, ve = (t.repeat_interleave(rhq // rhkv, dim=1) for t in (k, v))
    mask = live_mask(rs, rs, window=window, device=dev)
    rg_library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask), reps=10)
    rg_bound_ms, rg_bound_by, rg_flops = k4_bound(q, k, window=window)
    log(f"K4 at recurrentgemma's prefill shape {K4_RECURRENTGEMMA} window "
        f"{window}: {rg_ms:.3f} ms, plain {rg_plain_ms:.3f} ms, "
        f"scaled_dot_product_attention (window as a mask) "
        f"{rg_library_ms:.3f} ms, bound {rg_bound_ms:.3f} ms ({rg_bound_by}; "
        f"{rg_flops / 1e9:.1f} GFLOP, {rg_flops / rg_ms / 1e9:.1f} TFLOP/s "
        f"achieved, {100 * rg_bound_ms / rg_ms:.1f} % of the bound)")
    del q, k, v, ke, ve, mask
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": ATTENTION_SOURCE,
        "replaces": "src/repro/kernels/attention/kernel.py:36",
        "max_abs_err": worst,
        "matched": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "scaled_dot_product_attention(is_causal=True), softcap 0",
        "ms_softcap0": nocap_ms,
        "ms_simt_f32": simt_ms,
        "bound_share": bound_ms / ms,
        "tflops": flops / ms / 1e9,
        "shape": [b, s, hq, hkv, d],
        "dtype": "bfloat16",
        "softcap": 50.0,
        "gflop": flops / 1e9,
        "recurrentgemma": {
            "shape": list(K4_RECURRENTGEMMA), "window": window,
            "softcap": 0.0, "dtype": "bfloat16", "ms": rg_ms,
            "plain_ms": rg_plain_ms, "bound_ms": rg_bound_ms,
            "bound_by": rg_bound_by, "library_ms": rg_library_ms,
            "library": "scaled_dot_product_attention(attn_mask=window)",
            "bound_share": rg_bound_ms / rg_ms,
            "tflops": rg_flops / rg_ms / 1e9, "gflop": rg_flops / 1e9},
    }


def check_k4_moe_shapes(k4, dev):
    """K4 at the MoE archs' prefill shapes (``K4_MOE``: head dim 128,
    causal, no softcap, GQA 48/8 and 56/8, bfloat16) against its plain
    version, to one unit (``K4_TOL``) and within ``K4_REL_L2``, which the
    bf16-probability control must miss; each timed beside the plain
    version, ``scaled_dot_product_attention`` (the same function here: no
    softcap) and the bound. Returns {arch: numbers}."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    atol, rtol = K4_TOL["bfloat16"]
    out = {}
    for arch, (b, s, hq, hkv, d) in K4_MOE.items():
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        kw = dict(causal=True, window=0, softcap=0.0)
        what = f"K4 at {arch}'s prefill shape {(b, s, hq, hkv, d)} bfloat16"
        got = k4.flash_attention_cuda(q, k, v, **kw)
        want = k4.attention_bhsd_ref(q, k, v, **kw)
        got32, want32 = got.to(torch.float32), want.to(torch.float32)
        err = float((got32 - want32).abs().max())
        bad = ~torch.isclose(got32, want32, atol=atol, rtol=rtol)
        rel = rel_l2(got, want)
        control = rel_l2(attention_bf16_probs(q, k, v, **kw), want)
        del got32, want32
        log(f"{what}: max |diff| {err:.3g} within atol {atol:.3g} rtol "
            f"{rtol:.3g} ({int(bad.sum())} outside); relative L2 {rel:.4g} "
            f"(band {K4_REL_L2:.4g}); the bf16-probability control reads "
            f"{control:.4g}")
        if not torch.isfinite(got).all() or bool(bad.any()):
            fail(f"{what}: {int(bad.sum())} values outside one unit of the "
                 f"plain version (max |diff| {err})")
        if rel > K4_REL_L2 or control <= K4_REL_L2:
            fail(f"{what}: relative L2 {rel}, control {control}, band "
                 f"{K4_REL_L2}")
        del got, want, bad
        ms = median_ms(lambda: k4.flash_attention_cuda(q, k, v, **kw),
                       reps=10)
        plain_ms = median_ms(lambda: k4.attention_bhsd_ref(q, k, v, **kw),
                             reps=3)
        ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        library_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), reps=10)
        del ke, ve
        bound_ms, bound_by, flops = k4_bound(q, k, window=0)
        log(f"{what}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention {library_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved, "
            f"{100 * bound_ms / ms:.1f} % of the bound)")
        out[arch] = {
            "shape": [b, s, hq, hkv, d], "dtype": "bfloat16", "softcap": 0.0,
            "max_abs_err": err, "rel_l2": rel, "control_rel_l2": control,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention(is_causal=True)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9,
            "gflop": flops / 1e9}
        del q, k, v
    return out


def check_k4_training_shape(k4, dev):
    """K4 at gemma2's training shape, one microbatch (``TRAIN_BATCH`` over
    its microbatches, ``TRAIN_SEQ`` tokens, 8 query heads over 4, d 256,
    causal, softcap 50, bfloat16), the instance training runs (with
    ``lse``): against its plain version to one unit (``K4_TOL``) and
    within ``K4_REL_L2``, which the bf16-probability control must miss;
    timed beside the plain version, ``scaled_dot_product_attention``
    (softcap 0) and the bound. Returns its numbers."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    atol, rtol = K4_TOL["bfloat16"]
    b = TRAIN_BATCH // TRAIN_CONFIG["microbatches"]
    s, hq, hkv, d = TRAIN_SEQ, 8, 4, 256
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    kw = dict(causal=True, window=0, softcap=50.0)
    what = f"K4 at gemma2's training shape {(b, s, hq, hkv, d)} bfloat16"
    got, _ = k4.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want = k4.attention_bhsd_ref(q, k, v, **kw)
    got32, want32 = got.to(torch.float32), want.to(torch.float32)
    err = float((got32 - want32).abs().max())
    bad = ~torch.isclose(got32, want32, atol=atol, rtol=rtol)
    rel = rel_l2(got, want)
    control = rel_l2(attention_bf16_probs(q, k, v, **kw), want)
    del got32, want32
    log(f"{what}: max |diff| {err:.3g} within atol {atol:.3g} rtol "
        f"{rtol:.3g} ({int(bad.sum())} outside); relative L2 {rel:.4g} "
        f"(band {K4_REL_L2:.4g}); the bf16-probability control reads "
        f"{control:.4g}")
    if not torch.isfinite(got).all() or bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} values outside one unit of the "
             f"plain version (max |diff| {err})")
    if rel > K4_REL_L2 or control <= K4_REL_L2:
        fail(f"{what}: relative L2 {rel}, control {control}, band "
             f"{K4_REL_L2}")
    del got, want, bad
    ms = median_ms(lambda: k4.flash_attention_cuda(q, k, v, return_lse=True,
                                                   **kw), reps=20)
    plain_ms = median_ms(lambda: k4.attention_bhsd_ref(
        q, k, v, return_lse=True, **kw), reps=3)
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True), reps=20)
    del ke, ve
    bound_ms, bound_by, flops = k4_bound(q, k, window=0)
    log(f"{what}: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention (softcap 0) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved, "
        f"{100 * bound_ms / ms:.1f} % of the bound)")
    del q, k, v
    return {"shape": [b, s, hq, hkv, d], "dtype": "bfloat16", "softcap": 50.0,
            "max_abs_err": err, "rel_l2": rel, "control_rel_l2": control,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention(is_causal=True), "
                       "softcap 0",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gflop": flops / 1e9}


def check_k4_seamless_shapes(k4, dev):
    """K4 at seamless's prefill shapes (``K4_SEAMLESS``: non-causal, the
    query length the key length or the decoder's against the source's,
    head dim 64, no softcap) in float32 and bfloat16 against its plain
    version, to one unit (``K4_TOL``) and within ``K4_REL_L2``, which the
    bf16-probability control must miss; each bfloat16 shape timed beside
    the plain version, ``scaled_dot_product_attention`` (the same function
    here: no mask, no softcap) and the bound. Returns {name: numbers}."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(ENCDEC_SEED)
    out = {}
    for name, (b, hq, hkv, sq, skv, d) in K4_SEAMLESS.items():
        kw = dict(causal=False, window=0, softcap=0.0)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            atol, rtol = K4_TOL[dt]
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                     (b, hkv, skv, d)))
            what = (f"K4 at seamless's {name} shape q {(b, hq, sq, d)} k/v "
                    f"{(b, hkv, skv, d)} {dt} non-causal")
            before = collections.Counter(
                k4.flash_attention_cuda.route_launches)
            got = k4.flash_attention_cuda(q, k, v, **kw)
            route = by_route(collections.Counter(
                k4.flash_attention_cuda.route_launches) - before)
            want = k4.attention_bhsd_ref(q, k, v, **kw)
            got32, want32 = got.to(torch.float32), want.to(torch.float32)
            err = float((got32 - want32).abs().max())
            bad = ~torch.isclose(got32, want32, atol=atol, rtol=rtol)
            rel = rel_l2(got, want)
            control = rel_l2(attention_bf16_probs(q, k, v, **kw), want)
            del got32, want32
            log(f"{what}: {route}; max |diff| {err:.3g} within atol "
                f"{atol:.3g} rtol {rtol:.3g} ({int(bad.sum())} outside); "
                f"relative L2 {rel:.4g} (band {K4_REL_L2:.4g}); the "
                f"bf16-probability control reads {control:.4g}")
            if route != {f"{dt}/{DTYPE_ROUTE[dt]}": 1}:
                fail(f"{what}: launched {route}")
            if not torch.isfinite(got).all() or bool(bad.any()):
                fail(f"{what}: {int(bad.sum())} values outside one unit of "
                     f"the plain version (max |diff| {err})")
            if rel > K4_REL_L2 or control <= K4_REL_L2:
                fail(f"{what}: relative L2 {rel}, control {control}, band "
                     f"{K4_REL_L2}")
            out.setdefault(name, {})[dt] = {
                "max_abs_err": err, "rel_l2": rel, "control_rel_l2": control}
            del got, want, bad
            if dtype == torch.float32:
                del q, k, v
                continue
            ms = median_ms(lambda: k4.flash_attention_cuda(q, k, v, **kw),
                           reps=10)
            plain_ms = median_ms(lambda: k4.attention_bhsd_ref(q, k, v, **kw),
                                 reps=3)
            ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
            library_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve), reps=10)
            del ke, ve
            bound_ms, bound_by, flops = k4_bound(q, k, window=0, causal=False)
            log(f"{what}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"scaled_dot_product_attention {library_ms:.3f} ms "
                f"({ms / library_ms:.2f}x), bound {bound_ms:.4f} ms "
                f"({bound_by}; {flops / 1e9:.1f} GFLOP, "
                f"{flops / ms / 1e9:.1f} TFLOP/s achieved, "
                f"{100 * bound_ms / ms:.1f} % of the bound)")
            out[name].update({
                "shape_q": [b, hq, sq, d], "shape_kv": [b, hkv, skv, d],
                "causal": False, "softcap": 0.0, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "scaled_dot_product_attention()",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9,
                "gflop": flops / 1e9})
            del q, k, v
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ K6


def rglru_restarting(k6, a, b, h0, every=K6_RESTART):
    """A control for K6: its plain version restarted from zero every
    ``every`` steps after the first block (a kernel that drops the carry
    between the reference's time blocks, ``K6_RESTART``, or between its own
    tiles)."""
    import torch

    return torch.cat([
        k6.rglru_scan_ref(a[:, t:t + every], b[:, t:t + every],
                          h0 if t == 0 else None)
        for t in range(0, a.shape[1], every)], dim=1)


def check_k6(k6, dev):
    """K6 vs its plain version on the card, bit for bit, the kernel and
    ``ops.rglru_scan`` alike: the reference's four cases, a ragged sequence
    and width, and the serving shape with long-memory decays and a
    non-zero h0; controls restarting every ``K6_RESTART`` steps and every
    tile of the ring must differ. Times the kernel at the serving shape;
    returns its record."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    ring = k6.kernel.ring_config()
    tile = ring["steps"]

    def inputs(b, s, w, lo, hi):
        a = torch.rand((b, s, w), generator=gen, device=dev) * (hi - lo) + lo
        x = torch.randn((b, s, w), generator=gen, device=dev)
        h0 = torch.randn((b, w), generator=gen, device=dev)
        return a, x, h0

    cases = [(c, 0.3, 0.999) for c in K6_CASES]
    cases.append((K6_RAGGED, 0.3, 0.999))
    cases.append((K6_SERVING, *K6_LONG_MEMORY))
    worst = 0.0
    for (b, s, w), lo, hi in cases:
        a, x, h0 = inputs(b, s, w, lo, hi)
        want = k6.rglru_scan_ref(a, x, h0)
        what = f"(B, S, W) = {(b, s, w)}, a in U({lo}, {hi})"
        for name, got in (("ring kernel", k6.rglru_scan_cuda(a, x, h0)),
                          ("ops.rglru_scan", k6.rglru_scan(a, x, h0))):
            torch.cuda.synchronize()
            worst = max(worst, float((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"K6 {what}: the {name} differs from the plain version "
                     f"in {int((got != want).sum())} values (max |diff| "
                     f"{float((got - want).abs().max())})")
            del got
        notes = []
        for every in (K6_RESTART, tile):
            if s <= every:
                continue
            control = rglru_restarting(k6, a, x, h0, every)
            if torch.equal(control, want):
                fail(f"K6 {what}: the control restarting every {every} "
                     "steps equals the plain version")
            notes.append(f"restarting every {every} steps reads max |diff| "
                         f"{float((control - want).abs().max()):.4g}, "
                         f"relative L2 {rel_l2(control, want):.4g}")
            del control
        log(f"K6 {what}: the ring kernel and ops.rglru_scan bit-exact"
            + "".join(f"; the control {n}" for n in notes))
        del a, x, h0, want

    b, s, w = K6_SERVING
    a, x, h0 = inputs(b, s, w, *K6_LONG_MEMORY)
    # one launch at a time (``ms``, as K1-K5 are timed) and 10 back to back
    # (``steady_ms``: the device time without the wrapper's host time
    # before each launch)
    call = functools.partial(k6.rglru_scan_cuda, a, x, h0)
    ms = median_ms(call, reps=20)
    ring_steady_ms = steady_ms(call)
    plain_ms = median_ms(lambda: k6.rglru_scan_ref(a, x, h0), reps=3)
    # the same bytes as one streaming pass (a and b read, one tensor
    # written): what the card reaches without a recurrence; not K6's function
    out = torch.empty_like(a)
    add_ms = steady_ms(lambda: torch.add(a, x, out=out))
    # a and b read once, h0 read once, h written once; a multiply and an
    # add an element
    nbytes = 4 * (3 * a.numel() + h0.numel())
    bound_ms, bound_by = bound(nbytes, 2 * a.numel())

    def rates(t):
        return f"{t:.4f} ms, {nbytes / t / 1e6:.1f} GB/s, " \
               f"{100 * bound_ms / t:.1f} % of the bound"

    log(f"K6 at the serving shape {(b, s, w)} ({ring['lanes']} channels and "
        f"one warp a CTA, tiles of {ring['steps']} steps, {ring['stages']} "
        f"stages, {ring['ring_bytes']} bytes of ring), bound "
        f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB), plain "
        f"{plain_ms:.3f} ms; one launch at a time {rates(ms)}; 10 launches "
        f"back to back {rates(ring_steady_ms)}; torch.add of a and b (the "
        f"same bytes streamed, back to back) {add_ms:.4f} ms")
    return {
        "name": "rglru_scan",
        "route": "cuda",
        "source": RGLRU_SOURCE,
        "replaces": "src/repro/kernels/rglru/kernel.py:25",
        "max_abs_err": worst,
        "matched": worst == 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "steady_ms": ring_steady_ms,
        "bound_share": bound_ms / ms,
        "gbps": nbytes / ms / 1e6,
        "same_bytes_add_ms": add_ms,
        "shape": [b, s, w],
        "dtype": "float32",
    }


# ------------------------------------------------------------------ K5


def ssd_without_carry(k5, x, dt, a_neg, bmat, cmat, chunk):
    """The control for K5: its plain version with the state entering each
    chunk dropped (every chunk starts from zeros); the model's layout,
    returns (y, h_last)."""
    import torch

    ys, h = [], None
    for t in range(0, x.shape[1], chunk):
        y, h = k5.ssd_chunked_ref(x[:, t:t + chunk], dt[:, t:t + chunk],
                                  a_neg, bmat[:, t:t + chunk],
                                  cmat[:, t:t + chunk], chunk)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_flops(b, h, s, p, n, chunk) -> tuple[int, int]:
    """The chunked form's products on the live rows of each chunk of q
    rows, the causal triangle (i >= j) alone where it is one: (C Bᵀ, q(q +
    1) N; the rest: the scores times x·dt, q(q + 1) P, and C h_prevᵀ and the
    state update, 2 q P N each)."""
    cb = rest = 0
    for t in range(0, s, chunk):
        q = min(chunk, s - t)
        cb += q * (q + 1) * n
        rest += q * (q + 1) * p + 4 * q * p * n
    return b * h * cb, b * h * rest


def check_k5(k5, dev):
    """K5 vs its plain version on the card, y and h_last: the reference's
    three cases (also through the public ``ops.ssd_mixer``) and a ragged
    sequence with an initial state, each in float32 (the SIMT kernel) and
    bfloat16 (the tensor cores), and the mamba2 serving shape with
    long-memory inputs in both, and one sequence of it in bfloat16 with an
    initial state. Each comparison is elementwise (the reference's 1e-4,
    its worst element's share of that allowance logged) and in relative L2
    against ``K5_REL_L2``, which the no-carry control and, in bfloat16,
    the unsplit-operand control must fall outside. For the one sequence,
    logged only: the route's arithmetic in plain torch on the card
    (``ssd_chunked_split_ref``) and the plain version in float64, beside
    which the kernel, the emulation and the plain float32 version read.
    Then the serving shape's times: the tensor-core route, the float32
    SIMT kernel on the same inputs widened (the design it replaced), the
    plain version, and one sequence; returns the kernel's record."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    readings = {"float32": [], "bfloat16": []}

    def inputs(b, h, s, p, n, dt_range, a_range, dtype, with_h0):
        def u(shape, lo, hi):
            r = torch.rand(shape, generator=gen, device=dev)
            return r * (hi - lo) + lo

        x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
        dt = u((b, s, h), *dt_range)
        a_neg = -u((h,), *a_range)
        bm, cm = (torch.randn((b, s, n), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        h0 = (torch.randn((b, h, p, n), generator=gen, device=dev)
              if with_h0 else None)
        return x, dt, a_neg, bm, cm, h0

    def compare(what, got, want, controls, dtype):
        nonlocal worst
        torch.cuda.synchronize()
        for i, (part, g, w) in enumerate(zip(("y", "h_last"), got, want)):
            err = float((g - w).abs().max())
            bad = ~torch.isclose(g, w, atol=1e-4, rtol=1e-4)
            if not torch.isfinite(g).all() or bool(bad.any()):
                fail(f"K5 {what} {part}: {int(bad.sum())} values outside "
                     f"1e-4 of the plain version (max |diff| {err})")
            share = tolerance_share(g, w)
            rel = rel_l2(g, w)
            ctrl = {name: rel_l2(c[i], w) for name, c in controls.items()}
            readings[dtype].append((rel, share, ctrl))
            worst = max(worst, err)
            log(f"K5 {what} {part}: max |diff| {err:.3g} within 1e-4, the "
                f"worst element at {share:.3f} of 1e-4 + 1e-4|want|; "
                f"relative L2 {rel:.4g} (band {K5_REL_L2:.4g}); "
                + "; ".join(f"the {name} control reads {v:.4g}"
                            for name, v in ctrl.items()))
            if rel > K5_REL_L2:
                fail(f"K5 {what} {part}: relative L2 {rel} above {K5_REL_L2}")
            for name, v in ctrl.items():
                if v <= K5_REL_L2:
                    fail(f"K5 {what} {part}: the band {K5_REL_L2} does not "
                         f"tell the {name} control ({v}) from the kernel")

    def check(what, x, dt, a_neg, bm, cm, q, h0):
        got = k5.ssd_chunked_cuda(x.transpose(1, 2), dt.transpose(1, 2),
                                  a_neg, bm, cm, chunk=q, h0=h0)
        want = k5.ssd_chunked_ref(x, dt, a_neg, bm, cm, q, h0)
        controls = {"no-carry": ssd_without_carry(k5, x, dt, a_neg, bm, cm,
                                                  q)}
        dtype = str(x.dtype).removeprefix("torch.")
        if x.dtype == bf16:  # each float32 operand as one bf16 term
            controls["unsplit-operand"] = k5.ssd_chunked_split_ref(
                x, dt, a_neg, bm, cm, q, h0, terms=(1, 1, 1))
        compare(what, (got[0].transpose(1, 2), got[1]), want, controls,
                dtype)
        return got

    for ((b, h, s, p, n, q), with_h0), dtype in itertools.product(
            K5_CASES, (f32, bf16)):
        x, dt, a_neg, bm, cm, h0 = inputs(b, h, s, p, n, (0.01, 0.2),
                                          (0.5, 2.0), dtype, with_h0)
        what = (f"(B, H, S, P, N) = {(b, h, s, p, n)} chunk {q} "
                f"{str(dtype)[6:]} h0={with_h0}")
        got = check(what, x, dt, a_neg, bm, cm, q, h0)
        if not with_h0:
            xb, dtb = x.transpose(1, 2).contiguous(), dt.transpose(1, 2)
            mixed = k5.ssd_mixer(xb, dtb.contiguous(), a_neg, bm, cm, chunk=q)
            if not torch.equal(mixed, got[0].to(dtype)):
                fail(f"K5 {what}: ops.ssd_mixer differs from the kernel")
        del x, dt, bm, cm, h0, got

    b, h, s, p, n, q = K5_SERVING
    for dtype, with_h0 in ((f32, True), (bf16, False)):
        x, dt, a_neg, bm, cm, h0 = inputs(b, h, s, p, n, K5_DT_LONG,
                                          K5_A_LONG, dtype, with_h0)
        what = (f"serving shape {(b, h, s, p, n)} chunk {q} "
                f"{str(dtype)[6:]} h0={with_h0}, long memory")
        check(what, x, dt, a_neg, bm, cm, q, h0)
        torch.cuda.empty_cache()

    # timing at the serving shape in bfloat16, as the model hands it over:
    # heads ahead of the sequence by strides, no h0; beside it the float32
    # SIMT kernel on the same inputs widened (the bf16 design it replaced)
    xs, dts = x.transpose(1, 2), dt.transpose(1, 2)
    ms = median_ms(lambda: k5.ssd_chunked_cuda(xs, dts, a_neg, bm, cm,
                                               chunk=q), reps=10)
    xw, bw, cw = xs.to(f32), bm.to(f32), cm.to(f32)
    replaced_ms = median_ms(lambda: k5.ssd_chunked_cuda(xw, dts, a_neg, bw,
                                                        cw, chunk=q), reps=5)
    del xw, bw, cw
    plain_ms = median_ms(lambda: k5.ssd_chunked_ref(x, dt, a_neg, bm, cm, q),
                         reps=3)
    cb_flops, rest_flops = ssd_flops(b, h, s, p, n, q)
    flops = cb_flops + rest_flops
    # x, B, C (bf16) and dt, a (float32) read once; y and h_last (float32)
    # written once. Every product has one bf16 operand, and the route forms
    # them all on the bf16 tensor cores (the float32 operand split in bf16
    # terms, whose further passes are not counted, as K4's split P's are
    # not). C Bᵀ is counted once a head, as the kernel forms it. Beside it,
    # the bound as PRs 14-15 priced it: the products with a float32 operand
    # at the float32 rate outside the tensor cores
    nbytes = (2 * (x.numel() + bm.numel() + cm.numel())
              + 4 * (dt.numel() + a_neg.numel())
              + 4 * (x.numel() + b * h * p * n))
    bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_OPS_PER_S)
    simt_priced_ms, _ = bound(nbytes, rest_flops, tensor_ops=cb_flops)
    log(f"K5 at the serving shape: tensor cores {ms:.3f} ms, the replaced "
        f"SIMT kernel on widened inputs {replaced_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP, "
        f"{flops / ms / 1e9:.2f} TFLOP/s and {nbytes / ms / 1e6:.1f} GB/s "
        f"achieved; priced as before, {simt_priced_ms:.3f} ms)")

    # One sequence of the serving shape with an initial state, held as the
    # cases above. Where its worst elements come from, logged only: the
    # route's arithmetic in plain torch on the card, and each of the
    # kernel, that emulation and the plain version against the plain
    # version in float64
    x1, dt1, a1, bm1, cm1, h01 = inputs(1, h, s, p, n, K5_DT_LONG, K5_A_LONG,
                                        bf16, True)
    args1 = (x1, dt1, a1, bm1, cm1, q, h01)
    got1 = check(f"serving shape, one sequence {(1, h, s, p, n)} chunk {q} "
                 f"bfloat16 h0=True, long memory", *args1)
    got1 = (got1[0].transpose(1, 2), got1[1])
    want1 = k5.ssd_chunked_ref(*args1)
    emulated1 = k5.ssd_chunked_split_ref(*args1)
    exact1 = k5.ssd_chunked_ref(*args1, dtype=torch.float64)
    one_sequence = {
        f"{name} y": tolerance_share(g[0], w[0])
        for name, g, w in (("kernel vs emulation", got1, emulated1),
                           ("emulation vs plain", emulated1, want1),
                           ("kernel vs float64", got1, exact1),
                           ("emulation vs float64", emulated1, exact1),
                           ("plain vs float64", want1, exact1))}
    log("K5 one sequence, share of 1e-4 + 1e-4|want| taken by the worst y "
        "element (read only): " + "; ".join(
            f"{name} {v:.3f}" for name, v in one_sequence.items()))
    del got1, want1, emulated1, exact1
    one_ms = median_ms(lambda: k5.ssd_chunked_cuda(
        x1.transpose(1, 2), dt1.transpose(1, 2), a1, bm1, cm1, chunk=q),
        reps=10)
    log(f"K5 at one sequence of the serving shape: {one_ms:.3f} ms")
    rel = {dt_: max(r for r, _, _ in rs) for dt_, rs in readings.items()}
    share = {dt_: max(v for _, v, _ in rs) for dt_, rs in readings.items()}
    ctrl = {f"{dt_} {name}": min(c[name] for _, _, c in rs)
            for dt_, rs in readings.items() for name in rs[0][2]}
    return {
        "name": "ssd_chunked",
        "route": "cuda",
        "source": SSD_SOURCE,
        "replaces": "src/repro/kernels/ssd/kernel.py:30",
        "max_abs_err": worst,
        "matched": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "replaced_simt_ms": replaced_ms,
        "one_sequence_ms": one_ms,
        "shape": [b, h, s, p, n],
        "chunk": q,
        "dtype": "bfloat16 x, B, C; float32 dt",
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
        "rel_l2_max": rel,
        "tolerance_share_max": share,
        "one_sequence_tolerance_share": one_sequence,
        "control_rel_l2_min": ctrl,
    }


# ------------------------------------------------------------------ serving


def layer_kinds(cfg) -> list[str]:
    """Every layer's block kind, in execution order."""
    return list(cfg.block_pattern) * cfg.group_count + list(cfg.tail_pattern)


def uncounted_params(cfg) -> int:
    """The parameters that ``ModelConfig.param_count`` leaves out: the norm
    gains (one d_model vector before the head, one before each block's
    mixer and one before its FFN, which an ssd block lacks; in an
    encoder-decoder two in each encoder layer, one after the encoder and
    one before each decoder layer's cross attention), in an ssd block
    ``d_skip`` and the inner norm's gain (it counts two of the three
    per-head vectors), and in an MoE block the router (d_model x
    experts)."""
    total = cfg.d_model
    if cfg.encoder_layers:
        total += (2 * cfg.encoder_layers + 1 + cfg.num_layers) * cfg.d_model
    for kind in layer_kinds(cfg):
        if kind == "ssd":
            total += cfg.d_model + cfg.ssm_heads + cfg.ssm_d_inner
        else:
            total += 2 * cfg.d_model + cfg.d_model * cfg.num_experts
    return total


def replay_decode(bundle, params, prompts, tokens, handoff=None, extra=None):
    """The engine's decode of one batch again, fed its own tokens:
    ``prompts`` (B, S) and ``tokens`` (B, n) as served; ``handoff``, if
    given, is applied to each state entry of the prefill's cache before the
    first step; ``extra`` holds the prefill batch's other entries (an
    encoder-decoder's ``src_embeds``). Returns the decode steps' logits (B,
    n - 1, V) in float32."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg, dev = bundle.cfg, bundle.device
    b, s = prompts.shape
    n = tokens.shape[1]
    _, cache = bundle.prefill_fn(params, {"tokens": prompts, **(extra or {})})
    cache = tf.pad_cache_to(cache, cfg, s + n)
    if handoff is not None:
        entries = [e for section in cache.values() for e in section.values()]
        for entry in entries:
            for e in (entry if isinstance(entry, list) else [entry]):
                if "self" not in e:
                    handoff(e)
    steps = []
    for i in range(n - 1):
        pos = default_positions(cfg, b, 1, offset=s + i, device=dev)
        logits, cache = bundle.decode_fn(params, tokens[:, i:i + 1], pos,
                                         cache, s + i + 1)
        steps.append(logits[:, 0].to(torch.float32))
    return torch.stack(steps, dim=1)


def serve_and_check(bundle, params, reqs, counters,
                    observe=contextlib.nullcontext, tokens_out=None):
    """``reqs`` through ``ServeEngine.serve_queue`` in ``SERVE_SLOTS``
    slots, ``SERVE_NEW`` greedy tokens each, every prefill and decode step
    timed. Each kernel counter of ``counters`` (name -> wrapper) is set to 0
    before the run and read after it, and must equal one launch per layer
    of its block kinds per prefill. Then: the call counts, tokens in the
    vocabulary, the same tokens from a second run, and the first batch's
    decode, replayed, picking the served tokens. ``observe`` is a context
    factory around the first run alone; ``tokens_out``, if given, gets the
    first run's tokens appended. Returns the path's numbers and the first
    batch's (prompts, served tokens) on the card."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, dev = bundle.cfg, bundle.device
    calls = {"prefill": [], "decode": []}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            calls[name].append(time.perf_counter() - t)
            return out
        return run

    timed_bundle = dataclasses.replace(
        bundle, prefill_fn=timed("prefill", bundle.prefill_fn),
        decode_fn=timed("decode", bundle.decode_fn))
    engine = ServeEngine(timed_bundle, params,
                         ServeConfig(max_new_tokens=SERVE_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    routed = {name: collections.Counter(w.route_launches)
              for name, w in counters.items() if hasattr(w, "route_launches")}
    with observe():
        t0 = time.perf_counter()
        outs = engine.serve_queue(reqs, slots=SERVE_SLOTS)
        wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}
    routes = {name: by_route(collections.Counter(
        counters[name].route_launches) - before)
        for name, before in routed.items()}
    peak = torch.cuda.max_memory_allocated()
    seconds = {name: list(times) for name, times in calls.items()}
    prefills = -(-len(reqs) // SERVE_SLOTS)
    steps = prefills * (SERVE_NEW - 1)
    tokens = np.stack(outs)
    kinds = layer_kinds(cfg)
    want = {name: prefills * sum(KERNEL_OF_KIND.get(k) == name for k in kinds)
            for name in counters}
    log(f"serving path {cfg.name}: {len(reqs)} requests x {len(reqs[0])} "
        f"prompt tokens, {SERVE_SLOTS} slots, {SERVE_NEW} new tokens: wall "
        f"{wall:.2f}s, prefill {sum(seconds['prefill']):.3f}s over "
        f"{len(seconds['prefill'])} calls, decode "
        f"{sum(seconds['decode']):.3f}s over {len(seconds['decode'])} steps, "
        f"{tokens.size / wall:.1f} new tokens/s, launches {launches}, peak "
        f"device memory {peak / 2**30:.2f} GiB")
    if launches != want:
        fail(f"{cfg.name}: kernel launches {launches}, not {want} "
             f"({prefills} prefills of {len(kinds)} layers {kinds})")
    if (len(seconds["prefill"]), len(seconds["decode"])) != (prefills, steps):
        fail(f"{len(seconds['prefill'])} prefills and "
             f"{len(seconds['decode'])} decode steps, not {prefills}, {steps}")
    if tokens.shape != (len(reqs), SERVE_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens of shape {tokens.shape} outside [0, {cfg.vocab_size})")
    again = np.stack(engine.serve_queue(reqs, slots=SERVE_SLOTS))
    if not np.array_equal(tokens, again):
        fail(f"{cfg.name}: a second serve_queue gave other tokens "
             f"({int((tokens != again).sum())} differ)")
    log(f"serving path {cfg.name}: a second run gave the same {tokens.size} "
        f"tokens; first request's: {tokens[0].tolist()}")

    # The served tokens again: the first batch's decode replayed with them
    # must pick them again.
    prompts = torch.as_tensor(np.stack(reqs[:SERVE_SLOTS]), device=dev)
    served = torch.as_tensor(tokens[:SERVE_SLOTS], device=dev)
    picks = replay_decode(bundle, params, prompts, served).argmax(-1)
    if not torch.equal(picks.to(served.dtype), served[:, 1:]):
        fail(f"{cfg.name}: the replayed decode picked other tokens than the "
             "engine")
    log(f"serving path {cfg.name}: the first batch's decode, replayed with "
        "the served tokens, picks them again")
    if tokens_out is not None:
        tokens_out.append(tokens)
    return {
        "arch": cfg.name, "wall_s": wall, "prefill_s": seconds["prefill"],
        "decode_s": sum(seconds["decode"]),
        "decode_step_ms": 1e3 * statistics.median(seconds["decode"]),
        "new_tokens_per_s": tokens.size / wall, "launches": launches,
        "routes": routes, "peak_gib": peak / 2**30,
    }, prompts, served


def build_seeded(arch, seed, device=None, configure=None):
    """``build_model`` of the full-width ``arch`` (its config passed
    through ``configure``, if given: a cut depth or dtype) and its
    parameters from a ``torch.Generator`` seeded ``seed`` on the card, by
    the reference's init rule; checks the parameter count against the
    config's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if configure is not None:
        cfg = configure(cfg)
    bundle = build_model(cfg, device)
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    t0 = time.perf_counter()
    params = bundle.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    total, _ = cfg.param_count()
    if n_params != total + uncounted_params(cfg):
        fail(f"{n_params} parameters, the config counts {total} besides "
             f"{uncounted_params(cfg)} it leaves out")
    log(f"serving path {cfg.name}: {cfg.num_layers} layers "
        f"{layer_kinds(cfg)[:4]}... d={cfg.d_model} vocab={cfg.vocab_size}, "
        f"{n_params} parameters ({cfg.param_dtype}) from seed {seed} in "
        f"{init_s:.2f}s")
    return bundle, params, gen, {"params": n_params, "init_s": init_s}


def run_serving_path(kernels, counters, device=None):
    """Full-width gemma2_2b through ``build_model`` and
    ``ServeEngine.serve_queue`` on ``device`` (None = the CUDA card), with
    its checks; returns the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.models import build_model

    bundle, params, _, built = build_seeded(SERVE_ARCH, SERVE_SEED, device)
    cfg, dev = bundle.cfg, bundle.device
    rng = np.random.default_rng(SERVE_SEED)
    reqs = list(rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
                .astype(np.int32))
    tokens: list = []
    numbers, prompts, served = serve_and_check(bundle, params, reqs, counters,
                                               tokens_out=tokens)
    with phase(f"serving path {SERVE_ARCH} under a one-rank mesh"):
        mesh_serving = mesh_serving_path(bundle, params, reqs, counters,
                                         tokens[0], numbers, device)

    # Logits against plain references, in bfloat16 as served, then in
    # float32 (the same weights cast), where the rounding floor is low
    # enough for a band to tell a lower-precision control apart.
    batches = [torch.as_tensor(np.stack(reqs[i:i + SERVE_SLOTS]), device=dev)
               for i in range(0, SERVE_REQUESTS, SERVE_SLOTS)]
    bf16_probs = ("bf16-probability control",
                  lambda: sequence_attention(attention_bf16_probs))
    # beside them, what other attention arithmetic reads there: the plain
    # version with K4's split P, and the float32 SIMT kernel on widened
    # inputs (the replaced bf16 design)
    attributions = (
        ("plain version with split P", lambda: sequence_attention(
            functools.partial(attention_bf16_probs, split=True))),
        ("widened float32 SIMT kernel",
         lambda: sequence_attention(attention_widened)))
    bf16_logits = prefill_logits_check(bundle, params, batches, kernels,
                                       bf16_probs, LOGITS_BAND_BF16,
                                       separates=False,
                                       readings=attributions)
    params = params.to(torch.float32)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    bundle32 = build_model(cfg32, dev)
    f32_logits = prefill_logits_check(bundle32, params, batches[:1], kernels,
                                      bf16_probs, LOGITS_BAND_F32)
    int8 = build_model(dataclasses.replace(cfg32, kv_cache_dtype="int8"), dev)
    decode = teacher_forced_check(
        bundle32, params, prompts, served, kernels, DECODE_BAND_F32,
        {"int8 KV cache": (int8,), **{
            name: (bundle32, None, lambda fault=fault: decode_fault(fault))
            for name, fault in DECODE_FAULTS.items()}})
    with phase(f"serving path {SERVE_ARCH} float32 under a one-rank mesh"):
        mesh_serving.update(mesh_f32_checks(bundle32, int8, params, prompts,
                                            served, kernels, device))
    return {**numbers, **built, "prefill_logits_bf16": bf16_logits,
            "prefill_logits_f32": f32_logits, "decode_f32": decode,
            "mesh": mesh_serving}


@contextlib.contextmanager
def split_kv_calls(calls: list):
    """Count the split-KV decode steps the model takes (one for each
    self-attention layer a decode step under a split-KV mesh): each call
    appends 1 to ``calls``."""
    from repro_torch.models import attention

    plain = attention.decode_step_split_kv

    def counting(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    with swapped(attention, "decode_step_split_kv", counting):
        yield


@contextlib.contextmanager
def split_kv_window_dropped():
    """The split-KV decode without its window mask (a control)."""
    from repro_torch.models import attention

    plain = attention.decode_step_split_kv

    def faulty(*args, window=0, **kw):
        return plain(*args, window=0, **kw)

    with swapped(attention, "decode_step_split_kv", faulty):
        yield


def mesh_serving_path(bundle, params, reqs, counters, plain_tokens,
                      plain_numbers, device=None):
    """The serving path again under ``set_mesh`` of a one-rank (1, 1)
    ("data", "model") mesh (NCCL on the card): ``serve_and_check`` with
    its launch counts (K4 52) and checks, every decode step's attention
    through ``decode_step_split_kv`` (its calls from the first run alone
    must be one a self-attention layer a decode step: 26 x 30), the bf16
    greedy tokens logged beside the mesh-less run's with the number that
    differ, the wall and ms a decode step beside it, and the wall of a
    third, warm run under the mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.compat import set_mesh
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.partitioning import shard_module
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = bundle.cfg
    mesh = make_test_mesh((1, 1), ("data", "model"), device)
    # the parameters in the rules' layout (one rank: its shards are views
    # of the whole leaves)
    params = shard_module(params, bundle, mesh)
    calls: list = []
    served: list = []
    with set_mesh(mesh):
        numbers, _, _ = serve_and_check(
            bundle, params, reqs, counters,
            observe=lambda: split_kv_calls(calls), tokens_out=served)
    tokens = served[0]
    # a third run under the mesh, warm: what the first run's wall spent
    # once (the communicator, the first DTensors)
    engine = ServeEngine(bundle, params, ServeConfig(max_new_tokens=SERVE_NEW))
    with set_mesh(mesh):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.serve_queue(reqs, slots=SERVE_SLOTS)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
    steps = -(-len(reqs) // SERVE_SLOTS) * (SERVE_NEW - 1)
    attn_layers = sum(k in ("attn", "local_attn") for k in layer_kinds(cfg))
    want = steps * attn_layers
    differ = int((tokens != plain_tokens).sum())
    log(f"serving path {cfg.name} under a one-rank {dist.get_backend()} "
        f"mesh (1, 1): split-KV decode calls {len(calls)} (counted "
        f"{steps} steps x {attn_layers} layers = {want}); K4 launches "
        f"{numbers['launches']}")
    log(f"serving path {cfg.name} under the mesh: wall {numbers['wall_s']:.2f}s "
        f"(mesh-less {plain_numbers['wall_s']:.2f}s; a warm third run "
        f"{warm:.2f}s), prefill {sum(numbers['prefill_s']):.3f}s, decode "
        f"{numbers['decode_s']:.3f}s, "
        f"{numbers['decode_step_ms']:.2f} ms a decode step (mesh-less "
        f"{plain_numbers['decode_step_ms']:.2f}); bf16 greedy tokens, "
        f"{differ} of {tokens.size} differ from the mesh-less run's; first "
        f"request's {tokens[0].tolist()} (mesh-less "
        f"{plain_tokens[0].tolist()})")
    if len(calls) != want:
        fail(f"split-KV decode called {len(calls)} times, not {want}")
    dist.destroy_process_group()
    return {"split_kv_calls": len(calls), "tokens_differ": differ,
            "launches": numbers["launches"], "routes": numbers["routes"],
            "wall_s": numbers["wall_s"], "warm_wall_s": warm,
            "prefill_s": numbers["prefill_s"], "decode_s": numbers["decode_s"],
            "decode_step_ms": numbers["decode_step_ms"],
            "peak_gib": numbers["peak_gib"]}


def mesh_f32_checks(bundle32, int8, params, prompts, served, kernels,
                    device=None):
    """On the float32 weights under the one-rank mesh: the teacher-forced
    decode through the split-KV step (cache lengths past the 4,096 window)
    against the forward pass within ``DECODE_BAND_F32``, which the
    split-KV step without its window mask and the int8 cache through the
    split-KV step must miss, as phase 11's controls do; the float32 greedy
    tokens of the first batch equal to the mesh-less engine's."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.compat import set_mesh
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.partitioning import shard_module
    from repro_torch.serve import ServeConfig, ServeEngine

    mesh = make_test_mesh((1, 1), ("data", "model"), device)
    plain_params, params = params, shard_module(params, bundle32, mesh)
    calls: list = []
    with set_mesh(mesh), split_kv_calls(calls):
        # the int8 cache through the split-KV step is read as a control,
        # as phase 11 reads it: lower precision, outside the float32 band
        decode = teacher_forced_check(
            bundle32, params, prompts, served, kernels, DECODE_BAND_F32,
            {"int8 KV cache through split-KV": (int8,),
             "split-KV window dropped": (bundle32, None,
                                         split_kv_window_dropped)})
        config = ServeConfig(max_new_tokens=SERVE_NEW)
        got = ServeEngine(bundle32, params, config).generate(
            prompts.cpu().numpy())
    plain = ServeEngine(bundle32, plain_params, config).generate(
        prompts.cpu().numpy())
    log(f"serving path float32 under the mesh: {len(calls)} split-KV calls "
        f"in the decode checks; float32 greedy tokens of {got.shape[0]} "
        f"requests under the mesh "
        f"{'equal' if np.array_equal(got, plain) else 'NOT equal'} to the "
        f"mesh-less engine's (first {got[0].tolist()})")
    if not calls:
        fail("the float32 decode under the mesh took no split-KV step")
    if not np.array_equal(got, plain):
        fail(f"float32 greedy tokens under the mesh differ from the "
             f"mesh-less decode's in {int((got != plain).sum())} places")
    dist.destroy_process_group()
    return {"decode_f32": decode, "f32_tokens_equal": True}


def prefill_logits_check(bundle, params, batches, kernels, control, band,
                         separates=True, readings=()):
    """Each batch's last-position prefill logits through the kernels
    against the same model through their plain versions (sound), beside
    ``control`` = (name, context factory), the same model under a
    lower-precision or state-dropping control, and each of ``readings``
    (the same pairs), read and logged only. Fails when a sound reading
    passes ``band`` or, where the band ``separates``, when the control does
    not."""
    import torch

    name, faulty = control
    what = (f"{bundle.cfg.name} {bundle.cfg.param_dtype} "
            f"({bundle.cfg.num_layers} layers) prefill logits")
    sound, controls = [], []
    read = {name: [] for name, _ in readings}
    for batch in batches:
        batch = {"tokens": batch}
        got = bundle.prefill_fn(params, batch)[0]
        with plain_kernels(*kernels):
            plain = bundle.prefill_fn(params, batch)[0]
        with faulty():
            low = bundle.prefill_fn(params, batch)[0]
        if not torch.isfinite(got).all():
            fail(f"non-finite {what}")
        sound.append(rel_l2(got, plain))
        controls.append(rel_l2(low, plain))
        for reading, context in readings:
            with context():
                read[reading].append(rel_l2(bundle.prefill_fn(params, batch)[0],
                                            plain))
        agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
        log(f"serving path: {what} through the kernels vs their plain "
            f"versions: relative L2 {sound[-1]:.4g} (band {band:.4g}), argmax "
            f"agreement {agree:.2f}; the {name} reads {controls[-1]:.4g}"
            + "".join(f"; the {r} {v[-1]:.4g}" for r, v in read.items()))
    if max(sound) > band:
        fail(f"{what} through the kernels differ from the plain versions' "
             f"by {max(sound)} relative (band {band})")
    if separates and min(controls) <= band:
        fail(f"{what}: the band {band} does not tell the {name} "
             f"({min(controls)}) from the plain versions")
    return {"rel_l2": sound, "control_rel_l2": controls, "readings": read}


# faults of the decode path that the float32 teacher-forced band must
# catch: (cache_len, window) as the decode attention is called -> as the
# faulty one uses them
DECODE_FAULTS = {
    "window dropped": lambda n, w: (n, 0),
    "window one key too wide": lambda n, w: (n, w + 1 if w else 0),
    "new row unseen": lambda n, w: (n - 1, w),
}


@contextlib.contextmanager
def decode_fault(fault):
    """Run the model's decode attention with ``fault`` applied to its
    cache length and window."""
    from repro_torch.models import attention

    plain = attention.decode_attention

    def faulty(q, k_cache, v_cache, cache_len, *, window=0, attn_softcap=0.0):
        cache_len, window = fault(cache_len, window)
        return plain(q, k_cache, v_cache, cache_len, window=window,
                     attn_softcap=attn_softcap)

    attention.decode_attention = faulty
    try:
        yield
    finally:
        attention.decode_attention = plain


def teacher_forced_check(bundle, params, prompts, served, kernels, band,
                         controls):
    """Each decode step's logits, with the served tokens fed back, against
    the full-sequence forward pass through the plain kernels over the
    prompt and the tokens before it, at the same position (cache lengths S
    + 1 .. S + n - 1). ``controls`` maps a name to a faulty decode: (model
    bundle, hand-off applied to each state entry of the prefill's cache or
    None, context factory). The band must catch each control at some
    step."""
    import torch

    b, s = prompts.shape
    n = served.shape[1]
    with plain_kernels(*kernels):
        want = torch.stack([
            bundle.forward_fn(params, {"tokens": torch.cat(
                [prompts[j], served[j, :-1]])[None]})[0, s:].to(torch.float32)
            for j in range(b)])

    def readings(model, handoff=None, context=contextlib.nullcontext):
        with context():
            decoded = replay_decode(model, params, prompts, served, handoff)
        return [rel_l2(decoded[j, i], want[j, i])
                for j in range(b) for i in range(n - 1)]

    sound = readings(bundle)
    faulty = {name: readings(*spec) for name, spec in controls.items()}
    what = (f"{bundle.cfg.name} {bundle.cfg.param_dtype} "
            f"({bundle.cfg.num_layers} layers) teacher-forced decode")
    log(f"serving path: {what} ({b} requests x {n - 1} steps, cache length "
        f"{s + 1}..{s + n - 1}) vs the forward pass: relative L2 median "
        f"{statistics.median(sound):.4g}, max {max(sound):.4g} "
        f"(band {band:.4g}); controls, min and max: " + "; ".join(
            f"{name} {min(r):.4g}, {max(r):.4g}"
            for name, r in faulty.items()))
    if max(sound) > band:
        fail(f"{what} logits differ from the forward pass's by {max(sound)} "
             f"relative (band {band})")
    for name, r in faulty.items():
        if max(r) <= band:
            fail(f"{what}: the band {band} does not catch the control "
                 f"'{name}' (at most {max(r)})")
    return {"rel_l2_max": max(sound),
            "controls_rel_l2": {k: [min(r), max(r)]
                                for k, r in faulty.items()}}


# ------------------------------------------------------------------ state paths


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` replaced by ``fn`` for the duration."""
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


@contextlib.contextmanager
def plain_kernels(k4, k5, k6, carry=True):
    """Run the models' K4, K5 and K6 calls through their plain versions
    (the dispatch in each ``ops.py`` calls the swapped name for CUDA
    tensors); with ``carry=False``, K5 and K6 through the controls that
    drop the carried state (K5 at every chunk, K6 every ``K6_RESTART``
    steps; prefill only: K5's control ignores an initial state)."""
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    def ssd(x, dt, a_neg, bmat, cmat, *, chunk, h0=None):
        args = (x.transpose(1, 2), dt.transpose(1, 2), a_neg, bmat, cmat,
                chunk)
        y, h = (k5.ssd_chunked_ref(*args, h0) if carry
                else ssd_without_carry(k5, *args))
        return y.transpose(1, 2), h

    def rglru(a, b, h0=None):
        return (k6.rglru_scan_ref(a, b, h0) if carry
                else rglru_restarting(k6, a, b, h0))

    with sequence_attention(k4.attention_bhsd_ref), \
            swapped(ssd_ops, "ssd_chunked_cuda", ssd), \
            swapped(rglru_ops, "rglru_scan_cuda", rglru):
        yield


@contextlib.contextmanager
def emulated_ssd(k5, terms):
    """Run the models' K5 calls through K5's tensor-core arithmetic in
    plain torch (``ssd_chunked_split_ref``) with ``terms`` bf16 terms of
    its float32 operands: ``SPLIT_TERMS`` the kernel's own, ``(1, 1, 1)``
    the unsplit-operand control (the dispatch in ``kernels/ssd/ops.py``
    calls the swapped name for CUDA tensors)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    def ssd(x, dt, a_neg, bmat, cmat, *, chunk, h0=None):
        y, h = k5.ssd_chunked_split_ref(x.transpose(1, 2), dt.transpose(1, 2),
                                        a_neg, bmat, cmat, chunk, h0,
                                        terms=terms)
        return y.transpose(1, 2), h

    with swapped(ssd_ops, "ssd_chunked_cuda", ssd):
        yield


def ssd_bf16_checks(bundle, params, prompts, kernels, logits_band,
                    block_band):
    """mamba2's served bfloat16 prefill through K5 against the same weights
    through the plain versions: the last-position logits end to end within
    the relative-L2 ``logits_band``, and the first ssd block's contribution
    (output minus input, fed the input that the forward through the plain
    versions gives it) within ``block_band``; the no-carry and
    unsplit-operand controls must fall outside each. Both also read, logged
    only, the kernel's arithmetic in plain torch (where its reading comes
    from)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg, dev = bundle.cfg, bundle.device
    controls = (
        ("no-carry control", lambda: plain_kernels(*kernels, carry=False)),
        ("unsplit-operand control",
         lambda: emulated_ssd(kernels[1], (1, 1, 1))),
        ("split-operand emulation", lambda: emulated_ssd(
            kernels[1], kernels[1].ref.SPLIT_TERMS)))

    def held(what, readings, band):
        log(f"serving path: {cfg.name} {cfg.param_dtype} {what} vs the plain "
            f"version: relative L2 (band {band:.4g}) " + "; ".join(
                f"{name} {v:.4g}" for name, v in readings.items()))
        if not readings["kernels"] <= band:
            fail(f"{cfg.name} {what}: relative L2 {readings['kernels']} "
                 f"above {band}")
        for name in ("no-carry control", "unsplit-operand control"):
            if readings[name] <= band:
                fail(f"{cfg.name} {what}: the band {band} does not tell the "
                     f"{name} ({readings[name]}) from the plain version")
        return readings

    batch = {"tokens": prompts}
    with plain_kernels(*kernels):
        plain = bundle.prefill_fn(params, batch)[0]
    got = bundle.prefill_fn(params, batch)[0]
    if not torch.isfinite(got).all():
        fail(f"non-finite {cfg.name} {cfg.param_dtype} prefill logits")
    logits = {"kernels": rel_l2(got, plain)}
    for name, context in controls:
        with context():
            logits[name] = rel_l2(bundle.prefill_fn(params, batch)[0], plain)
    del plain, got
    held("prefill logits through K5", logits, logits_band)

    record = []
    with plain_kernels(*kernels), recorded_blocks(record):
        bundle.prefill_fn(params, batch)
    at = layer_kinds(cfg).index("ssd")
    x = record[at][0]
    del record
    kind, layer, _ = list(tf.layers_in_order(params, cfg))[at]
    positions = default_positions(cfg, x.shape[0], x.shape[1], device=dev)

    def contribution(context):
        with context():
            out, _, _ = tf.block_apply_seq(layer, x, positions, cfg, kind)
        return out.to(torch.float32) - x.to(torch.float32)

    want = contribution(lambda: plain_kernels(*kernels))
    block = {"kernels": rel_l2(contribution(contextlib.nullcontext), want)}
    for name, context in controls:
        block[name] = rel_l2(contribution(context), want)
    held(f"ssd block {at} through K5", block, block_band)
    return {"logits_rel_l2": logits, "block": {"layer": at, "rel_l2": block}}


def redraw_decays(params, cfg, gen):
    """The one cut from the reference's init rule: the decay parameters,
    whose init (a_log = dt_bias = 0, lam = 1) makes both recurrences forget
    within a few tokens, are drawn from the published init ranges, so that
    state carries over hundreds of tokens as with trained weights.
    Mamba-2: A = exp(a_log) in U(1, 16), softplus(dt_bias) log-uniform in
    [1e-3, 1e-1]; Griffin: a = sigmoid(lam)^c in U(0.9, 0.999)."""
    import math

    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.rglru import C_FACTOR

    def u(n, lo, hi):
        return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo

    with torch.no_grad():
        for kind, layer, _ in tf.layers_in_order(params, cfg):
            if kind == "ssd":
                mixer = layer["ssd"]
                h = mixer["a_log"].numel()
                mixer["a_log"].copy_(torch.log(u(h, 1.0, 16.0)))
                dt = torch.exp(u(h, math.log(1e-3), math.log(1e-1)))
                mixer["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
            elif kind == "rec":
                lam = layer["rec"]["lam"]
                s = u(lam.numel(), 0.9, 0.999) ** (1.0 / C_FACTOR)
                lam.copy_(torch.log(s) - torch.log1p(-s))


def zero_state(entry):
    entry["h"].zero_()


def drop_conv_tail(entry):
    entry["conv"].zero_()


@contextlib.contextmanager
def recorded_blocks(record):
    """Append each block's (input, output) to ``record`` as the decoder
    runs it."""
    from repro_torch.models import transformer as tf

    inner = tf.block_apply_seq

    def run(params, x, positions, cfg, kind, *args, **kw):
        out = inner(params, x, positions, cfg, kind, *args, **kw)
        record.append((x, out[0]))
        return out

    with swapped(tf, "block_apply_seq", run):
        yield


def layerwise_check(bundle, params, prompt, served, kernels, bands):
    """Every block fed the inputs that it gets in the forward pass through
    the plain kernels over ``prompt`` (1, S) and the served tokens before
    the last, so that no difference carries from one layer to the next:
    its prefill over the prompt through the kernels, and then its decode
    steps over the served tokens, continuing the entry that the prefill
    handed over, against that forward pass. Each reading is the relative L2
    of the block's contribution (output minus input). ``bands`` maps each
    block kind to its (prefill, decode) bands, and each band must leave its
    controls outside: in a state block the no-carry prefill and the decode
    with its state zeroed or its conv tail dropped at the hand-off; in an
    attention block the bf16-probability prefill and the decode with its
    window dropped."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg, dev = bundle.cfg, bundle.device
    s, n = prompt.shape[1], served.shape[1]
    tokens = torch.cat([prompt, served[:, :-1]], dim=1)
    record, through_kernels = [], []
    with plain_kernels(*kernels), recorded_blocks(record):
        bundle.prefill_fn(params, {"tokens": tokens})
    with recorded_blocks(through_kernels):
        bundle.prefill_fn(params, {"tokens": tokens})
    # how far the kernels' own forward drifts from the plain one, block by
    # block (a diagnostic: each block here also takes the other's input)
    drift = [rel_l2(yk, yp) for (_, yk), (_, yp) in zip(through_kernels,
                                                         record)]
    del through_kernels
    log(f"serving path: {cfg.name} {cfg.param_dtype} forward through the "
        f"kernels vs the plain versions, each block's output in turn: "
        f"relative L2 " + ", ".join(f"{d:.2g}" for d in drift))
    positions = default_positions(cfg, 1, tokens.shape[1], device=dev)
    nothing = contextlib.nullcontext
    # per kind of entry: the prefill's control, and the decode's variants
    # (name -> (hand-off applied to the entry, context of the steps))
    state_checks = (
        ("no-carry control", lambda: plain_kernels(*kernels, carry=False)),
        {"sound": (None, nothing),
         "state zeroed at hand-off": (zero_state, nothing),
         "conv tail dropped at hand-off": (drop_conv_tail, nothing)})
    # (Of DECODE_FAULTS only the dropped window: with these weights the
    # attention is near one-hot, so one key more or less than the window,
    # or the new row unseen, leaves the output unchanged unless that key
    # holds the maximum; on the card both read as the sound decode.)
    attention_checks = (
        ("bf16-probability control",
         lambda: sequence_attention(attention_bf16_probs)),
        {"sound": (None, nothing), "window dropped": (
            None, lambda: decode_fault(DECODE_FAULTS["window dropped"]))})
    # stage -> kind -> reading name -> readings
    readings = {stage: {kind: {} for kind in set(layer_kinds(cfg))}
                for stage in ("prefill", "decode")}
    layers = list(tf.layers_in_order(params, cfg))
    if len(layers) != len(record):
        fail(f"{len(record)} blocks recorded, {len(layers)} layers")
    for (kind, layer, _), (x, y) in zip(layers, record):
        want = y - x
        pre = x[:, :s]
        prefill = readings["prefill"][kind]
        got, entry, _ = tf.block_apply_seq(layer, pre, positions[..., :s],
                                           cfg, kind)
        prefill.setdefault("sound", []).append(rel_l2(got - pre, want[:, :s]))
        (control, faulty), variants = (
            attention_checks if "self" in entry else state_checks)
        with faulty():
            ctrl, _, _ = tf.block_apply_seq(layer, pre, positions[..., :s],
                                            cfg, kind)
        prefill.setdefault(control, []).append(rel_l2(ctrl - pre,
                                                      want[:, :s]))
        for name, (handoff, context) in variants.items():
            step = tf.pad_cache_to({"groups": {}, "tail": {"0": entry}}, cfg,
                                   s + n)["tail"]["0"]
            step = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in step.items()}
            if handoff is not None:
                handoff(step)
            with context():
                for t in range(s, s + n - 1):
                    out, new = tf.block_apply_step(
                        layer, x[:, t:t + 1], positions[..., t:t + 1], step,
                        t + 1, cfg, kind)
                    step.update(new)
                    readings["decode"][kind].setdefault(name, []).append(
                        rel_l2(out - x[:, t:t + 1], want[:, t:t + 1]))
    del record
    what = f"{cfg.name} {cfg.param_dtype} layer by layer"
    for (stage, by_kind), i in zip(readings.items(), (0, 1)):
        for kind, by_name in sorted(by_kind.items()):
            band = bands[kind][i]
            sound = by_name["sound"]
            count = layer_kinds(cfg).count(kind)
            log(f"serving path: {what}, {stage}, {count} {kind} layers: "
                f"relative L2 max {max(sound):.4g} (band "
                f"{band:.4g})" + "".join(
                    f"; {name} max {max(r):.4g}"
                    for name, r in by_name.items() if name != "sound"))
            if max(sound) > band:
                fail(f"{what}, {stage}, {kind}: relative L2 {max(sound)} "
                     f"above {band}")
            for name, r in by_name.items():
                if name != "sound" and max(r) <= band:
                    fail(f"{what}, {stage}, {kind}: the band {band} does not "
                         f"catch the control '{name}' (at most {max(r)})")
    return {"drift": drift, **{
        stage: {kind: {name: max(r) for name, r in by_name.items()}
                for kind, by_name in by_kind.items()}
        for stage, by_kind in readings.items()}}


def attention_peak(q, k, **kw) -> dict:
    """How peaked the plain version's attention is: the std of the scaled
    scores over the live (q, k) pairs, and over queries and heads the median
    and the 90th percentile of the probability mass off each row's largest
    key (1 minus the largest probability, from the exponentials of the
    other keys' score gaps, so that it reads below float32's unit at 1)."""
    import torch

    s, mask = attention_scores(q, k, **kw)
    std = float(s.masked_select(mask.expand_as(s)).std())
    gaps = s - s.masked_fill(~mask, -2e38).amax(-1, keepdim=True)
    e = torch.exp(gaps).masked_fill(~mask, 0.0)
    off = e.masked_fill(gaps == 0, 0.0).sum(-1)
    off = (off / (1 + off)).flatten().to(torch.float64)
    return {"score_std": std, "off_top_median": float(off.median()),
            "off_top_p90": float(off.quantile(0.9))}


def attention_sharpness(bundle, params, prompt, kernels, extra=None):
    """``attention_peak`` of each attention layer in turn, in the forward
    pass of ``bundle`` through the plain kernels over ``prompt`` (1, S)
    (and ``extra``, the batch's other entries)."""
    k4 = kernels[0]
    stats = []

    def probe(q, k, v, **kw):
        stats.append(attention_peak(q, k, **kw))
        return k4.attention_bhsd_ref(q, k, v, **kw)

    with plain_kernels(*kernels), sequence_attention(probe):
        bundle.prefill_fn(params, {"tokens": prompt, **(extra or {})})
    log(f"serving path: {bundle.cfg.name} {bundle.cfg.param_dtype} "
        "attention, layer by layer: score std " + ", ".join(
            f"{a['score_std']:.4g}" for a in stats) + "; mass off the "
        "largest key, median (90th percentile) " + ", ".join(
            f"{a['off_top_median']:.3g} ({a['off_top_p90']:.3g})"
            for a in stats))
    return stats


def run_state_serving_path(arch, kernels, counters, device=None):
    """Full-width ``arch`` (mamba2_1_3b or recurrentgemma_2b) through
    ``build_model`` and ``ServeEngine.serve_queue`` on ``device`` (None =
    the CUDA card), its decay parameters redrawn (``redraw_decays``), with
    its checks: the serving checks of ``serve_and_check``, then, on the
    weights cast to float32 and at the depth that ``STATE_SERVING`` gives,
    the prefill logits and the teacher-forced decode against bands from
    chip readings that their no-carry, hand-off and attention-fault
    controls must fall outside, and every block at full depth
    (``layerwise_check``). Returns the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.models import build_model

    spec = STATE_SERVING[arch]
    bundle, params, gen, built = build_seeded(arch, STATE_SEED, device)
    redraw_decays(params, bundle.cfg, gen)
    cfg, dev = bundle.cfg, bundle.device
    rng = np.random.default_rng(STATE_SEED)
    reqs = list(rng.integers(0, cfg.vocab_size,
                             (SERVE_REQUESTS, spec["prompt"]))
                .astype(np.int32))
    numbers, prompts, served = serve_and_check(bundle, params, reqs, counters)
    bf16 = ({"prefill_bf16": ssd_bf16_checks(
        bundle, params, prompts, kernels, spec["bf16_logits_band"],
        spec["bf16_block_band"])} if "bf16_block_band" in spec else {})

    params = params.to(torch.float32)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    bundle32 = build_model(cfg32, dev)
    # the first layers and the tail, on the same weights
    cut = build_model(dataclasses.replace(cfg32, num_layers=spec["layers"]),
                      dev)
    logits = prefill_logits_check(
        cut, params, [prompts], kernels,
        ("no-carry control", lambda: plain_kernels(*kernels, carry=False)),
        spec["logits_band"])
    decode = teacher_forced_check(
        cut, params, prompts, served, kernels, spec["decode_band"],
        {"state zeroed at hand-off": (cut, zero_state),
         "conv tail dropped at hand-off": (cut, drop_conv_tail),
         **{name: (cut, None, lambda f=DECODE_FAULTS[name]: decode_fault(f))
            for name in spec["decode_faults"]}})
    outcome = {**numbers, **built, **bf16, "prompt": spec["prompt"],
               "end_to_end_layers": spec["layers"],
               "prefill_logits_f32": logits, "decode_f32": decode}
    if "flash_attention" in (KERNEL_OF_KIND[k] for k in layer_kinds(cfg)):
        outcome["attention_sharpness_f32"] = attention_sharpness(
            bundle32, params, prompts[:1], kernels)
    outcome["layerwise_f32"] = layerwise_check(
        bundle32, params, prompts[:1], served[:1], kernels,
        spec["layer_bands"])
    del params
    torch.cuda.empty_cache()
    return outcome


# ------------------------------------------------------------------ K4b


def k4b_bound(q, k, *, window, causal=True, q_offset=0):
    """K4b's bound at q (B, Hq, Sq, d) and k/v (B, Hkv, Skv, d) of q's
    dtype: q, k, v, the output, its gradient and lse read once and dq,
    dk, dv written once; 10·d operations per live (q, k) pair and query
    head (q·k recomputed, dV, dP, dQ, dK) at the card's peak for the
    operands' type (bf16 on the tensor cores, float32 outside them).
    Returns (ms, bound_by, operations)."""
    import torch

    b, hq, sq, d = q.shape
    size = q.element_size()
    nbytes = size * (4 * q.numel() + 4 * k.numel()) + 4 * b * hq * sq
    flops = 10 * b * hq * d * live_pairs(sq, k.shape[2], causal, window,
                                         q_offset)
    peak = (BF16_TENSOR_OPS_PER_S if q.dtype == torch.bfloat16
            else F32_OPS_PER_S)
    return (*bound(nbytes, flops, peak), flops)


def in_turns(fns: dict, reps: int, rounds: int = 2) -> tuple[dict, dict]:
    """Each of ``fns`` (name -> callable) timed by ``median_ms`` in turns,
    the order reversed every round (a b c, c b a, ...); returns ({name:
    the median of its rounds' medians}, {name: each round's median})."""
    times = {n: [] for n in fns}
    order = list(fns)
    for r in range(rounds):
        for n in order if r % 2 == 0 else order[::-1]:
            times[n].append(median_ms(fns[n], reps=reps))
    return {n: statistics.median(t) for n, t in times.items()}, times


def attention_bwd_faulty(q, k, v, out, dout, lse, *, fault, **kw):
    """K4b's plain version (``attention_bwd_ref``) with one fault put in,
    the control for K4b's bands: ``"no softcap derivative"`` takes the
    softcap's derivative as 1, ``"delta zero"`` sets ``delta = rowsum(dO *
    O)`` to 0 (dS = P dP), ``"bf16 operands"`` rounds q, k, v, the output
    and its gradient to bfloat16 first (the operands of a bf16 tensor-core
    route); ``"one ulp"``, a witness rather than a fault, moves a seeded
    half of their elements by one float32 ulp (float32 rounding's own
    spread)."""
    import torch

    import math

    from repro_torch.kernels.attention import ref

    if fault == "delta zero":
        out = torch.zeros_like(out)
    elif fault == "bf16 operands":
        q, k, v, out, dout = (t.to(torch.bfloat16).to(t.dtype)
                              for t in (q, k, v, out, dout))
    elif fault == "one ulp":
        gen = torch.Generator(device=q.device).manual_seed(TRAIN_SEED)
        q, k, v, out, dout = (
            torch.where(torch.rand(t.shape, generator=gen, device=t.device)
                        < 0.5, torch.nextafter(t, torch.full_like(t, math.inf)),
                        t) for t in (q, k, v, out, dout))
    else:
        assert fault == "no softcap derivative", fault
        with swapped(ref, "softcap_grad", lambda u, cap: torch.ones_like(u)):
            return ref.attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    return ref.attention_bwd_ref(q, k, v, out, dout, lse, **kw)


def check_k4b(k4, dev):
    """K4b against its plain version on the card at gemma2's training
    shape (causal, softcap 50), recurrentgemma's (one key/value head,
    window 2048), dbrx's and seamless's two non-causal shapes
    (``K4B_CASES``), in float32 and bfloat16,
    within ``K4B_REL_L2`` per gradient, bit-identical from one call to the
    next, each launch on its dtype's route (``DTYPE_ROUTE``); the controls
    must fall outside: in float32, those of ``attention_bwd_faulty`` (with
    a softcap, where q is scaled so that the scores reach its bend); in
    bfloat16 the unsplit control
    (``attention_bwd_rounded_ref`` with bf16 P and dS), beside which the
    route's own arithmetic in plain torch (two terms) is logged. At
    gemma2's shape in bfloat16 it times, in turns, the tensor-core route,
    ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` (softcap 0, backward only) and the
    plain version; seamless's shapes are timed by
    ``k4b_seamless_times``. Returns the kernel's record."""
    import torch
    import torch.nn.functional as F

    smem = {d: k4.kernel.bwd_shared_memory(d) for d in k4.kernel.HEAD_DIMS}
    log("K4b's tensor-core kernels, dynamic shared memory a CTA (bytes): "
        + json.dumps(smem))
    if any(n > MAX_SHARED_BYTES for by in smem.values() for n in by.values()):
        fail(f"K4b: shared memory above {MAX_SHARED_BYTES} bytes: {smem}")
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    worst, worst_abs, routes, readings = {}, 0.0, {}, {}
    for (b, hq, hkv, sq, skv, d), causal, window, cap in K4B_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            for q_scale in ((1.0, 8.0) if dtype == torch.float32 and cap
                            else (1.0,)):
                q, k, v, do = (
                    torch.randn(shape, generator=gen, device=dev)
                    for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                  (b, hkv, skv, d), (b, hq, sq, d)))
                q = (q * q_scale).to(dtype)
                k, v, do = k.to(dtype), v.to(dtype), do.to(dtype)
                kw = dict(causal=causal, window=window, softcap=cap)
                out, lse = k4.flash_attention_cuda(q, k, v, return_lse=True,
                                                   **kw)
                before = collections.Counter(
                    k4.flash_attention_bwd_cuda.route_launches)
                got = k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
                again = k4.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                                    **kw)
                route = by_route(collections.Counter(
                    k4.flash_attention_bwd_cuda.route_launches) - before)
                want = k4.attention_bwd_ref(q, k, v, out, do, lse, **kw)
                torch.cuda.synchronize()
                what = (f"K4b {dt} q {(b, hq, sq, d)} k/v {(b, hkv, skv, d)} "
                        f"causal {causal} window {window} softcap {cap} q x "
                        f"{q_scale}")
                if route != {f"{dt}/{DTYPE_ROUTE[dt]}": 2}:
                    fail(f"{what}: two calls launched {route}")
                routes[what] = route
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"{what}: two calls differ")
                rels = [rel_l2(x, y) for x, y in zip(got, want)]
                band = K4B_REL_L2[dt]
                worst[dt] = max(worst.get(dt, 0.0), *rels)
                worst_abs = max(worst_abs, *(
                    float((x.float() - y.float()).abs().max())
                    for x, y in zip(got, want)))
                del got, again
                controls, witness = {}, {}
                if dtype == torch.float32:
                    for fault in ("no softcap derivative", "delta zero"):
                        if fault == "no softcap derivative" and not cap:
                            continue
                        bad = attention_bwd_faulty(q, k, v, out, do, lse,
                                                   fault=fault, **kw)
                        controls[fault] = max(rel_l2(x, y)
                                              for x, y in zip(bad, want))
                        del bad
                else:
                    for terms, into in ((1, controls), (2, witness)):
                        emulated = k4.attention_bwd_rounded_ref(
                            q, k, v, out, do, lse, terms=terms, **kw)
                        into[f"{terms}-term P and dS in plain torch"] = [
                            rel_l2(x, y) for x, y in zip(emulated, want)]
                        del emulated
                    controls = {n: max(r) for n, r in controls.items()}
                readings[what] = {"rel_l2": rels, "controls": controls,
                                  "witness": witness}
                log(f"{what}: {route}; relative L2 dq {rels[0]:.3g}, dk "
                    f"{rels[1]:.3g}, dv {rels[2]:.3g} (band {band:.3g}); "
                    f"bit-identical twice; controls " + json.dumps(
                        {n: float(f"{c:.4g}") for n, c in controls.items()})
                    + ("; the route's arithmetic " + json.dumps(
                        {n: [float(f"{x:.4g}") for x in r]
                         for n, r in witness.items()}) if witness else ""))
                if max(rels) > band:
                    fail(f"{what}: relative L2 {rels} above {band}")
                if q_scale > 1.0 or not cap or dtype == torch.bfloat16:
                    for name, c in controls.items():
                        if c <= band:
                            fail(f"{what}: the control '{name}' ({c}) is "
                                 f"inside the band {band}")
                del q, k, v, do, out, lse, want
                torch.cuda.empty_cache()

    seamless = k4b_seamless_times(k4, gen)
    (b, hq, hkv, s, _, d), _, window, cap = K4B_CASES[0]
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                                 (b, hq, s, d)))
    kw = dict(causal=True, window=window, softcap=cap)
    out, lse = k4.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (
        q, k.repeat_interleave(hq // hkv, dim=1),
        v.repeat_interleave(hq // hkv, dim=1)))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    times, rounds = in_turns({
        "tensor_core": lambda: k4.flash_attention_bwd_cuda(
            q, k, v, out, do, lse, **kw),
        "library": lambda: torch.autograd.grad(
            lib_out, (qs, ks, vs), do, retain_graph=True),
        "plain": lambda: k4.attention_bwd_ref(q, k, v, out, do, lse, **kw),
    }, reps=5)
    ms, plain_ms = times["tensor_core"], times["plain"]
    bound_ms, bound_by, flops = k4b_bound(q, k, window=window)
    executed = K4B_EXECUTED * flops
    log(f"K4b at gemma2's training shape {(b, hq, hkv, s, d)} bf16 softcap "
        f"{cap}, timed in turns (each round's median "
        + json.dumps({n: [round(t, 4) for t in r] for n, r in rounds.items()})
        + f"): tensor cores {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention backward (softcap 0) "
        f"{times['library']:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}; "
        f"{flops / 1e9:.1f} GFLOP at the bf16 tensor-core rate), "
        f"{100 * bound_ms / ms:.2f} % of the bound; "
        f"{flops / ms / 1e9:.1f} TFLOP/s of the bound's work, "
        f"{executed / ms / 1e9:.1f} TFLOP/s executed ({executed / 1e9:.1f} "
        f"GFLOP: 20 d a live pair)")
    del q, k, v, do, out, lse, qs, ks, vs, lib_out
    torch.cuda.empty_cache()
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": ATTENTION_SOURCE,
        "replaces": "src/repro/models/attention.py:181 (_flash_core_bwd, "
                    "not a Pallas kernel)",
        "max_abs_err": worst_abs,
        "max_rel_l2": worst,
        "matched": True,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["library"],
        "library": "torch.autograd.grad through "
                   "scaled_dot_product_attention(is_causal=True), softcap 0, "
                   "backward only",
        "times_in_turns": rounds,
        "bound_share": bound_ms / ms,
        "tflops": flops / ms / 1e9,
        "executed_tflops": executed / ms / 1e9,
        "gflop": flops / 1e9,
        "shape": [b, hq, hkv, s, d],
        "dtype": "bfloat16",
        "softcap": cap,
        "routes_by_case": routes,
        "readings": readings,
        "shared_memory": smem,
        "seamless": seamless,
    }


def k4b_seamless_times(k4, gen):
    """K4b at seamless's training shapes (``K4B_SEAMLESS``: the encoder and
    the cross attention, non-causal, bfloat16), timed in turns beside
    ``torch.autograd.grad`` through ``scaled_dot_product_attention`` (the
    same function: no mask, no softcap; backward only) and the plain
    version, with the bound (10 d a live pair at the bf16 tensor-core
    rate). Returns {name: numbers}."""
    import torch
    import torch.nn.functional as F

    dev = gen.device
    out = {}
    for name, case in K4B_SEAMLESS.items():
        (b, hq, hkv, sq, skv, d), causal, window, cap = K4B_CASES[case]
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                     (b, hkv, skv, d), (b, hq, sq, d)))
        kw = dict(causal=causal, window=window, softcap=cap)
        o, lse = k4.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (
            q, k.repeat_interleave(hq // hkv, dim=1),
            v.repeat_interleave(hq // hkv, dim=1)))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs)
        times, rounds = in_turns({
            "tensor_core": lambda: k4.flash_attention_bwd_cuda(
                q, k, v, o, do, lse, **kw),
            "library": lambda: torch.autograd.grad(
                lib_out, (qs, ks, vs), do, retain_graph=True),
            "plain": lambda: k4.attention_bwd_ref(q, k, v, o, do, lse, **kw),
        }, reps=5)
        bound_ms, bound_by, flops = k4b_bound(q, k, window=window,
                                              causal=causal)
        ms = times["tensor_core"]
        log(f"K4b at seamless's {name} training shape q {(b, hq, sq, d)} "
            f"k/v {(b, hkv, skv, d)} bf16 non-causal, timed in turns (each "
            "round's median " + json.dumps(
                {n: [round(t, 4) for t in r] for n, r in rounds.items()})
            + f"): tensor cores {ms:.3f} ms, plain {times['plain']:.3f} ms, "
            f"scaled_dot_product_attention backward "
            f"{times['library']:.3f} ms ({ms / times['library']:.2f}x); "
            f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP), "
            f"{100 * bound_ms / ms:.2f} % of the bound")
        out[name] = {
            "shape_q": [b, hq, sq, d], "shape_kv": [b, hkv, skv, d],
            "causal": causal, "dtype": "bfloat16", "ms": ms,
            "plain_ms": times["plain"], "library_ms": times["library"],
            "library": "torch.autograd.grad through "
                       "scaled_dot_product_attention, backward only",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gflop": flops / 1e9,
            "times_in_turns": rounds}
        del q, k, v, do, o, lse, qs, ks, vs, lib_out
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ K4 and K4b with a query offset


def k4_offset_record(what, got, want, kw, q, k, v):
    """One K4 call with a query offset held against its plain version:
    elementwise at ``K4_TOL`` of the output's dtype, and in bfloat16 also
    within ``K4_REL_L2``, which the bf16-probability control must miss;
    returns the readings."""
    import torch

    dt = str(got.dtype)[6:]
    atol, rtol = K4_TOL[dt]
    g32, w32 = got.to(torch.float32), want.to(torch.float32)
    torch.cuda.synchronize()
    err = float((g32 - w32).abs().max())
    bad = int((~torch.isclose(g32, w32, atol=atol, rtol=rtol)).sum())
    if not torch.isfinite(g32).all() or bad:
        fail(f"K4 {what}: {bad} values outside atol {atol} rtol {rtol} of "
             f"the plain version (max |diff| {err})")
    reading = {"max_abs_err": err, "rel_l2": rel_l2(got, want)}
    if dt == "bfloat16":
        reading["control_rel_l2"] = rel_l2(
            attention_bf16_probs(q, k, v, **kw), want)
        if (reading["rel_l2"] > K4_REL_L2
                or reading["control_rel_l2"] <= K4_REL_L2):
            fail(f"K4 {what}: relative L2 {reading['rel_l2']}, the "
                 f"bf16-probability control {reading['control_rel_l2']}, "
                 f"band {K4_REL_L2}")
    log(f"K4 {what}: max |diff| {err:.3g} within atol {atol:.3g} rtol "
        f"{rtol:.3g}; " + json.dumps({n: float(f"{x:.4g}")
                                      for n, x in reading.items()}))
    return reading


def offset_control(k4, what, q, k, v, want, kw):
    """The same call launched with ``q_offset=0``: it must fall outside
    ``K4_REL_L2`` of the offset's plain version, which shows that the
    offset reaches the kernel's masks. Returns its relative L2."""
    wrong = rel_l2(k4.flash_attention_cuda(q, k, v, **dict(kw, q_offset=0)),
                   want)
    log(f"K4 {what}: the offset-0 control reads {wrong:.4g} "
        f"(band {K4_REL_L2:.4g})")
    if wrong <= K4_REL_L2:
        fail(f"K4 {what}: launched with q_offset 0 it reads {wrong}, inside "
             f"the band {K4_REL_L2}: the offset does not reach the masks")
    return wrong


def k4_offset_times(k4, q, k, v, kw, lse=False):
    """K4 with an offset timed as phase 5 times it: the kernel, its plain
    version, ``scaled_dot_product_attention`` with the explicit boolean
    mask (softcap 0: it has none) on key/value heads expanded outside the
    timing, and the bound from the live pairs counted with the offset."""
    import torch.nn.functional as F

    hq, sq, skv = q.shape[1], q.shape[2], k.shape[2]
    extra = dict(return_lse=True) if lse else {}
    ms = median_ms(lambda: k4.flash_attention_cuda(q, k, v, **kw, **extra),
                   reps=10)
    plain_ms = median_ms(lambda: k4.attention_bhsd_ref(q, k, v, **kw,
                                                       **extra), reps=3)
    ke, ve = (t.repeat_interleave(hq // k.shape[1], dim=1) for t in (k, v))
    mask = live_mask(sq, skv, causal=kw["causal"], window=kw["window"],
                     q_offset=kw["q_offset"], device=q.device)
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, attn_mask=mask), reps=10)
    bound_ms, bound_by, flops = k4_bound(q, k, window=kw["window"],
                                         causal=kw["causal"],
                                         q_offset=kw["q_offset"])
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention(attn_mask=live "
                       "pairs), softcap 0",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "gflop": flops / 1e9,
            "tflops": flops / ms / 1e9}


def check_k4_offset(k4, dev):
    """Phase 5a: K4 and K4b with a query offset at gemma2's attention (Hq 8
    over 4, d 256, softcap 50). The chunked prefill of phase 11's prompts
    (``K4_CHUNKS`` chunks of 1,152 rows, each over its prefix of keys,
    ``q_offset`` its first row) at windows 0 and 4096, each chunk against
    its plain version, the chunks stacked against the whole-prompt call,
    and each chunk past the first launched at offset 0 as the control; the
    ragged offset (``K4_RAGGED``) in both dtypes; the refusal of a call
    that leaves a row no live key; K4b at the second half of phase 13's
    microbatch (``K4B_OFFSET``) in both dtypes. Each new K4 shape and the
    K4b one timed (``k4_offset_times``). Returns ({"chunked_prefill",
    "ragged", "dead_row"}, K4b's record)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    hq, hkv, d, cap = 8, 4, 256, 50.0

    def qkv(b, sq, skv, dtype, q_scale=1.0):
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        return q.mul_(q_scale).to(dtype), k.to(dtype), v.to(dtype)

    def launched(dtype, fn):
        """``fn()`` and the route it launched, one launch of the dtype's."""
        before = collections.Counter(k4.flash_attention_cuda.route_launches)
        got = fn()
        route = by_route(collections.Counter(
            k4.flash_attention_cuda.route_launches) - before)
        dt = str(dtype)[6:]
        if route != {f"{dt}/{DTYPE_ROUTE[dt]}": 1}:
            fail(f"K4 {dt} with an offset launched {route}")
        return got

    # the chunked prefill of phase 11's prompts
    b, s = 4, SERVE_PROMPT
    n = s // K4_CHUNKS
    q, k, v = qkv(b, s, s, bf16)
    chunked = {}
    for window in K4_OFFSET_WINDOWS:
        base = dict(causal=True, window=window, softcap=cap, q_offset=0)
        whole = k4.flash_attention_cuda(q, k, v, **base)
        parts, rows = [], []
        for c in range(K4_CHUNKS):
            lo, hi = c * n, (c + 1) * n
            qc, kc, vc = q[:, :, lo:hi], k[:, :, :hi], v[:, :, :hi]
            kw = dict(base, q_offset=lo)
            what = (f"chunk {c} of the {s}-token prefill (q {tuple(qc.shape)}"
                    f" over k/v {tuple(kc.shape)}, q_offset {lo}, window "
                    f"{window})")
            got = launched(bf16, lambda: k4.flash_attention_cuda(qc, kc, vc,
                                                                 **kw))
            want = k4.attention_bhsd_ref(qc, kc, vc, **kw)
            reading = k4_offset_record(what, got, want, kw, qc, kc, vc)
            if lo:
                reading["offset0_control_rel_l2"] = offset_control(
                    k4, what, qc, kc, vc, want, kw)
            reading.update(k4_offset_times(k4, qc, kc, vc, kw))
            log(f"K4 {what}: {reading['ms']:.3f} ms, plain "
                f"{reading['plain_ms']:.3f} ms, "
                f"scaled_dot_product_attention (mask, softcap 0) "
                f"{reading['library_ms']:.3f} ms, bound "
                f"{reading['bound_ms']:.3f} ms ({reading['bound_by']}; "
                f"{reading['gflop']:.1f} GFLOP, {reading['tflops']:.1f} "
                f"TFLOP/s, {100 * reading['bound_share']:.1f} % of the "
                f"bound)")
            parts.append(got)
            rows.append(dict(reading, chunk=c, q_offset=lo,
                             shape=[b, hq, hkv, n, hi, d]))
            del want
        stacked = torch.cat(parts, dim=2)
        atol, rtol = K4_TOL["bfloat16"]
        err = float((stacked.float() - whole.float()).abs().max())
        outside = int((~torch.isclose(stacked.float(), whole.float(),
                                      atol=atol, rtol=rtol)).sum())
        rel = rel_l2(stacked, whole)
        log(f"K4 the {K4_CHUNKS} chunks stacked against the whole-prompt "
            f"call (q_offset 0), window {window}: max |diff| {err:.3g} "
            f"({outside} outside atol {atol:.3g} rtol {rtol:.3g}), relative "
            f"L2 {rel:.4g} (band {K4_REL_L2:.4g})")
        if outside or rel > K4_REL_L2:
            fail(f"K4 chunked prefill window {window}: the chunks stacked "
                 f"differ from the whole call ({outside} outside, relative "
                 f"L2 {rel})")
        chunked[f"window {window}"] = {
            "chunks": rows, "stacked_max_abs_err": err,
            "stacked_rel_l2": rel}
        del whole, parts, stacked
    del q, k, v
    torch.cuda.empty_cache()

    # the ragged offset: no tile edge lines up
    rb, rsq, rskv, roff = (K4_RAGGED[key] for key in
                           ("b", "sq", "skv", "q_offset"))
    ragged = {}
    for dtype in (f32, bf16):
        q, k, v = qkv(rb, rsq, rskv, dtype)
        for window in K4_RAGGED["windows"]:
            kw = dict(causal=True, window=window, softcap=cap,
                      q_offset=roff)
            what = (f"{str(dtype)[6:]} ragged offset (q {tuple(q.shape)} "
                    f"over k/v {tuple(k.shape)}, q_offset {roff}, window "
                    f"{window})")
            got = launched(dtype, lambda: k4.flash_attention_cuda(q, k, v,
                                                                  **kw))
            want = k4.attention_bhsd_ref(q, k, v, **kw)
            reading = k4_offset_record(what, got, want, kw, q, k, v)
            reading["offset0_control_rel_l2"] = offset_control(
                k4, what, q, k, v, want, kw)
            if dtype == bf16:
                reading.update(k4_offset_times(k4, q, k, v, kw))
                log(f"K4 {what}: {reading['ms']:.3f} ms, plain "
                    f"{reading['plain_ms']:.3f} ms, "
                    f"scaled_dot_product_attention (mask, softcap 0) "
                    f"{reading['library_ms']:.3f} ms, bound "
                    f"{reading['bound_ms']:.4f} ms ({reading['bound_by']})")
            ragged[f"{str(dtype)[6:]} window {window}"] = reading
            del got, want
        del q, k, v

    # a call that leaves a query row no live key raises before any launch
    q, k, v = qkv(1, 64, 128, bf16)
    dead = dict(causal=True, window=32, softcap=cap, q_offset=128)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=f32, device=dev)
    before = (k4.flash_attention_cuda.launches,
              k4.flash_attention_bwd_cuda.launches)
    messages = {}
    for name, call in (
            ("ops.flash_attention", lambda: k4.flash_attention(
                *(t.transpose(1, 2) for t in (q, k, v)), **dead)),
            ("flash_attention_cuda", lambda: k4.flash_attention_cuda(
                q, k, v, **dead)),
            ("flash_attention_bwd_cuda", lambda: k4.flash_attention_bwd_cuda(
                q, k, v, out, out, lse, **dead))):
        try:
            call()
        except ValueError as e:
            messages[name] = str(e)
        else:
            fail(f"K4 {name}: a call with a dead row (q_offset 128, 64 rows "
                 f"over 128 keys, window 32) did not raise")
        if "no live key" not in messages[name]:
            fail(f"K4 {name}: the dead-row refusal says {messages[name]!r}")
    if (k4.flash_attention_cuda.launches,
            k4.flash_attention_bwd_cuda.launches) != before:
        fail("K4: a dead-row call launched a kernel")
    log("K4 and K4b refuse a dead row with ValueError, no launch: "
        + json.dumps(messages))
    del q, k, v, out, lse

    # K4b with the offset at the training shape's second half
    (b, _, _, sq, skv, _), off, cap = K4B_OFFSET
    k4b = {}
    for dtype, q_scale in ((f32, 8.0), (bf16, 1.0)):
        dt = str(dtype)[6:]
        q, k, v = qkv(b, sq, skv, dtype, q_scale)
        do = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
        kw = dict(causal=True, window=0, softcap=cap, q_offset=off)
        out, lse = k4.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        before = collections.Counter(
            k4.flash_attention_bwd_cuda.route_launches)
        got = k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        again = k4.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
        route = by_route(collections.Counter(
            k4.flash_attention_bwd_cuda.route_launches) - before)
        want = k4.attention_bwd_ref(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        what = (f"K4b {dt} q {tuple(q.shape)} k/v {tuple(k.shape)} q_offset "
                f"{off} softcap {cap} q x {q_scale}")
        if route != {f"{dt}/{DTYPE_ROUTE[dt]}": 2}:
            fail(f"{what}: two calls launched {route}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{what}: two calls differ")
        rels = [rel_l2(x, y) for x, y in zip(got, want)]
        band = K4B_REL_L2[dt]
        controls, witness = {}, {}
        if dtype == f32:
            for fault in ("no softcap derivative", "delta zero"):
                bad = attention_bwd_faulty(q, k, v, out, do, lse,
                                           fault=fault, **kw)
                controls[fault] = max(rel_l2(x, y)
                                      for x, y in zip(bad, want))
                del bad
        else:
            for terms, into in ((1, controls), (2, witness)):
                emulated = k4.attention_bwd_rounded_ref(
                    q, k, v, out, do, lse, terms=terms, **kw)
                into[f"{terms}-term P and dS in plain torch"] = max(
                    rel_l2(x, y) for x, y in zip(emulated, want))
                del emulated
        controls["q_offset 0"] = max(rel_l2(x, y) for x, y in zip(
            k4.flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                        **dict(kw, q_offset=0)), want))
        log(f"{what}: {route}; relative L2 dq {rels[0]:.3g}, dk "
            f"{rels[1]:.3g}, dv {rels[2]:.3g} (band {band:.3g}); "
            f"bit-identical twice; controls " + json.dumps(
                {n: float(f"{c:.4g}") for n, c in controls.items()})
            + ("; the route's arithmetic " + json.dumps(
                {n: float(f"{c:.4g}") for n, c in witness.items()})
               if witness else ""))
        if max(rels) > band:
            fail(f"{what}: relative L2 {rels} above {band}")
        for name, c in controls.items():
            if c <= band:
                fail(f"{what}: the control '{name}' ({c}) is inside the "
                     f"band {band}")
        reading = {"rel_l2": rels, "controls": controls, "witness": witness,
                   "max_abs_err": max(float((x.float() - y.float()).abs()
                                            .max())
                                      for x, y in zip(got, want))}
        del got, again, want
        if dtype == bf16:
            # K4 at this shape (the instance with lse), then K4b in turns
            # with SDPA's backward (explicit mask, softcap 0) and the plain
            # version
            k4_times = k4_offset_times(k4, q, k, v, kw, lse=True)
            log(f"K4 with lse at {tuple(q.shape)} over {tuple(k.shape)} "
                f"q_offset {off}: {k4_times['ms']:.3f} ms, plain "
                f"{k4_times['plain_ms']:.3f} ms, "
                f"scaled_dot_product_attention (mask, softcap 0) "
                f"{k4_times['library_ms']:.3f} ms, bound "
                f"{k4_times['bound_ms']:.4f} ms ({k4_times['bound_by']})")
            reading["k4"] = k4_times
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (
                q, k.repeat_interleave(hq // hkv, dim=1),
                v.repeat_interleave(hq // hkv, dim=1)))
            mask = live_mask(sq, skv, q_offset=off, device=dev)
            lib_out = F.scaled_dot_product_attention(qs, ks, vs,
                                                     attn_mask=mask)
            times, rounds = in_turns({
                "tensor_core": lambda: k4.flash_attention_bwd_cuda(
                    q, k, v, out, do, lse, **kw),
                "library": lambda: torch.autograd.grad(
                    lib_out, (qs, ks, vs), do, retain_graph=True),
                "plain": lambda: k4.attention_bwd_ref(q, k, v, out, do, lse,
                                                      **kw),
            }, reps=5)
            bound_ms, bound_by, flops = k4b_bound(q, k, window=0,
                                                  q_offset=off)
            reading.update(
                ms=times["tensor_core"], plain_ms=times["plain"],
                library_ms=times["library"],
                library="torch.autograd.grad through "
                        "scaled_dot_product_attention(attn_mask=live pairs), "
                        "softcap 0, backward only",
                times_in_turns=rounds, bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / times["tensor_core"],
                gflop=flops / 1e9, shape=list(K4B_OFFSET[0]), q_offset=off)
            log(f"{what}: timed in turns " + json.dumps(
                {n: [round(t, 4) for t in r] for n, r in rounds.items()})
                + f": tensor cores {times['tensor_core']:.3f} ms, plain "
                f"{times['plain']:.3f} ms, SDPA backward (mask, softcap 0) "
                f"{times['library']:.3f} ms; bound {bound_ms:.3f} ms "
                f"({bound_by}; {flops / 1e9:.1f} GFLOP), "
                f"{100 * bound_ms / times['tensor_core']:.2f} % of the bound")
            del qs, ks, vs, lib_out, mask
        k4b[dt] = reading
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return ({"chunked_prefill": chunked, "ragged": ragged,
             "dead_row": messages}, k4b)


# ------------------------------------------------------------------ training


@contextlib.contextmanager
def plain_training(k4, k5, k6):
    """The kernels' plain versions forward and backward (``plain_kernels``
    with K4b's plain version too)."""
    from repro_torch.kernels.attention import ops as attn_ops

    with plain_kernels(k4, k5, k6), swapped(
            attn_ops, "flash_attention_bwd_cuda", k4.attention_bwd_ref):
        yield


def gradients(bundle, params, batch):
    """The loss and every parameter's gradient, by name."""
    import torch

    loss, _ = bundle.loss_fn(params, batch)
    names, leaves = zip(*params.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


def worst_leaf(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative L2 of ``got`` against ``want`` over the leaves,
    and the leaf's name."""
    return max((rel_l2(got[n], want[n]), n) for n in want)


def rglru_bwd_without_carry(a, h, h0, g):
    """The control for K6's gradient: the backward scan with the carried
    adjoint dropped (``dh_t = g_t``, no ``a_{t+1} dh_{t+1}``)."""
    import torch

    first = torch.zeros_like(h[:, :1]) if h0 is None else h0[:, None]
    h_prev = torch.cat([first, h[:, :-1]], dim=1)
    g = g.to(torch.float32)
    return g * h_prev, g, None if h0 is None else a[:, 0] * g[:, 0]


def rglru_bwd_without_dh0(a, h, h0, g, *, bwd):
    """The control for K6's gradient: the backward ``bwd`` with ``dh0``
    dropped."""
    da, db, dh0 = bwd(a, h, h0, g)
    return da, db, None if dh0 is None else dh0 * 0


def softcap_witness(q, k, kw, scales):
    """At one attention layer's q (B, Hq, S, d) and k (B, Hkv, S, d) and
    its masks and softcap (``kw``), with the scores ``u = q·k / sqrt(d)`` scaled by each of ``scales``
    (name -> factor): the median ``|u| / cap`` over the live pairs, and the
    probabilities times the softcap's derivative, ``P (1 - tanh^2(u /
    cap))``, which every dS carries, computed in float32 against float64,
    relative L2: how much of that factor float32 rounding alone leaves."""
    import math

    import torch

    from repro_torch.kernels.attention.ref import (
        _mask, softcap_fn, softcap_grad,
    )

    cap = kw["softcap"]
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    u = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.double().reshape(b, -1, g, s, d), k.double())
    u = u / math.sqrt(d)
    live = _mask(s, s, causal=kw["causal"], window=kw["window"], q_offset=0,
                 skv_valid=s, device=q.device)
    out = {}
    for name, factor in scales.items():
        x = u * factor
        p = torch.softmax(softcap_fn(x, cap).masked_fill(~live, -math.inf),
                          dim=-1)
        want = p * softcap_grad(x, cap)
        got = p.float() * softcap_grad(x.float(), cap)
        out[name] = {
            "scale": factor,
            "median_abs_u_over_cap": float(x[..., live].abs().median() / cap),
            "p_softcap_grad_f32_vs_f64_rel_l2": float(
                (got.double() - want).norm() / want.norm()),
        }
        del x, p, want, got
    return out


def gradient_checks(kernels, counters, device=None, archs=None,
                    configure=None, k6_shape=GRAD_K6):
    """One float32 step's gradients at full width and reduced depth
    (``GRAD_CHECKS``) through the kernels (K4 with K4b, K5's Function, K6
    forward and reversed) against the same step through their plain
    versions, by relative L2 per leaf within ``GRAD_REL_L2``; each arch's
    controls must fall outside. Then K6's Function alone at the serving
    shape (``k6_shape``) with an initial state, whose gradients must equal
    the plain version's bit for bit and the dh0-dropped control's must
    not. ``configure``, if given, maps each config before it is built (a
    rehearsal on the host shrinks the widths)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.models import build_model

    k4, k5, k6 = kernels
    controls = {
        "K4b without the softcap derivative": lambda: swapped(
            attn_ops, "flash_attention_bwd_cuda", functools.partial(
                attention_bwd_faulty, fault="no softcap derivative")),
        "K4b with delta zero": lambda: swapped(
            attn_ops, "flash_attention_bwd_cuda", functools.partial(
                attention_bwd_faulty, fault="delta zero")),
        "K4b on bf16-rounded operands": lambda: swapped(
            attn_ops, "flash_attention_bwd_cuda", functools.partial(
                attention_bwd_faulty, fault="bf16 operands")),
        "K4b's plain version on operands one ulp apart": lambda: swapped(
            attn_ops, "flash_attention_bwd_cuda", functools.partial(
                attention_bwd_faulty, fault="one ulp")),
        "K6's backward without the carried adjoint": lambda: swapped(
            rglru_ops, "rglru_scan_bwd", rglru_bwd_without_carry),
        "K5 without the carried state": lambda: plain_kernels(
            k4, k5, k6, carry=False),
    }
    out = {}
    for arch, spec in (archs or GRAD_CHECKS).items():
        cfg = dataclasses.replace(get_config(arch), num_layers=spec["layers"],
                                  param_dtype="float32",
                                  compute_dtype="float32")
        cfg = configure(cfg) if configure else cfg
        bundle = build_model(cfg, device)
        gen = torch.Generator(device=bundle.device).manual_seed(TRAIN_SEED)
        params = bundle.init(gen, trainable=True)
        redraw_decays(params, cfg, gen)
        wq_scale = spec.get("wq_scale", 1.0)
        with torch.no_grad():
            for name, p in params.named_parameters():
                if name.endswith("attn.wq"):
                    p.mul_(wq_scale)
        rng = np.random.default_rng(TRAIN_SEED)
        toks = rng.integers(0, cfg.vocab_size, (spec["batch"], spec["seq"] + 1))
        batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
                 "targets": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}
        for w in counters.values():
            w.launches = 0
        first = []
        forward = attn_ops._forward

        def kept_first(q, k, v, kw, return_lse=False):
            if not first:
                first.append((q.detach(), k.detach(), kw))
            return forward(q, k, v, kw, return_lse)

        with swapped(attn_ops, "_forward", kept_first):
            loss, got = gradients(bundle, params, batch)
        launches = {n: w.launches for n, w in counters.items()}
        witness = None
        if first and first[0][2]["softcap"] > 0:
            q, k, kw = first[0]
            witness = softcap_witness(q, k, kw,
                                      {"seeded": 1 / wq_scale, "run": 1.0})
            log(f"softcap witness {arch}, layer 0 (live causal pairs): "
                + json.dumps(witness))
        del first
        with plain_training(k4, k5, k6):
            plain_loss, want = gradients(bundle, params, batch)
        rel, leaf = worst_leaf(got, want)
        band = GRAD_REL_L2[arch]
        readings = {}
        for name in (*spec["controls"], *spec.get("witnesses", ())):
            with plain_training(k4, k5, k6), controls[name]():
                _, bad = gradients(bundle, params, batch)
            readings[name] = worst_leaf(bad, want)
            del bad
        seen = {n: readings.pop(n) for n in spec.get("witnesses", ())}
        log(f"gradient check {arch} at {spec['layers']} layers, batch "
            f"{spec['batch']} x {spec['seq']}, float32: loss {float(loss):.6f}"
            f" (plain {float(plain_loss):.6f}), launches {launches}; worst "
            f"leaf {leaf} relative L2 {rel:.4g} (band {band:.3g}); controls "
            + json.dumps({n: [float(f"{r:.4g}"), lf]
                          for n, (r, lf) in readings.items()})
            + ("; witnesses " + json.dumps({n: [float(f"{r:.4g}"), lf]
                                            for n, (r, lf) in seen.items()})
               if seen else ""))
        if not torch.isfinite(loss) or rel > band:
            fail(f"gradient check {arch}: leaf {leaf} at relative L2 {rel} "
                 f"above {band}")
        for name, (r, lf) in readings.items():
            if r <= band:
                fail(f"gradient check {arch}: the control '{name}' ({r} at "
                     f"{lf}) is inside the band {band}")
        out[arch] = {"rel_l2": rel, "leaf": leaf, "band": band,
                     "launches": launches, "controls": {
                         n: r for n, (r, _) in readings.items()},
                     "witnesses": {n: r for n, (r, _) in seen.items()},
                     **({"softcap_witness": witness} if witness else {})}
        del params, got, want, bundle
        torch.cuda.empty_cache()

    # K6's Function with an initial state: the kernel's reversed launch
    # against the plain scan, bit for bit
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    b, s, w = k6_shape
    a = (torch.rand((b, s, w), generator=gen, device=dev)
         * (K6_LONG_MEMORY[1] - K6_LONG_MEMORY[0]) + K6_LONG_MEMORY[0])
    x, g = (torch.randn((b, s, w), generator=gen, device=dev)
            for _ in range(2))
    h0 = torch.randn((b, w), generator=gen, device=dev)

    def scan_grads():
        leaves = [t.detach().clone().requires_grad_() for t in (a, x, h0)]
        return torch.autograd.grad(k6.rglru_scan(*leaves), leaves, g)

    before = k6.rglru_scan_cuda.launches
    got = scan_grads()
    k6_launches = k6.rglru_scan_cuda.launches - before
    with swapped(rglru_ops, "rglru_scan_cuda", k6.rglru_scan_ref):
        want = scan_grads()
        with swapped(rglru_ops, "rglru_scan_bwd", functools.partial(
                rglru_bwd_without_dh0, bwd=rglru_ops.rglru_scan_bwd)):
            bad = scan_grads()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, want)):
        fail("K6's gradient at the serving shape differs from the plain "
             "scan's: " + ", ".join(f"{rel_l2(p, q):.3g}"
                                    for p, q in zip(got, want)))
    if torch.equal(bad[2], want[2]):
        fail("K6's gradient: the dh0-dropped control equals the plain scan's")
    log(f"K6's gradient at {k6_shape} with h0: da, db, dh0 bit-exact with the "
        f"plain scan run backwards ({k6_launches} K6 launches: forward and "
        f"reversed); the dh0-dropped control reads relative L2 "
        f"{rel_l2(bad[2], want[2]):.4g} in dh0")
    out["rglru_scan_h0"] = {"bit_exact": True, "launches": k6_launches}
    return out


class StepClock:
    """Wraps a train step: each call synchronised and timed on the host,
    K4b's device time inside it summed from CUDA events around each of its
    calls, and the state it returns kept (``last``)."""

    def __init__(self, step):
        self.step = step
        self.seconds, self.k4b_ms, self.last = [], [], None

    def __call__(self, state, batch):
        import torch

        from repro_torch.kernels.attention import ops as attn_ops

        events = []
        kernel = attn_ops.flash_attention_bwd_cuda

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*args, **kw)
            end.record()
            events.append((start, end))
            return out

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with swapped(attn_ops, "flash_attention_bwd_cuda", timed):
            state, metrics = self.step(state, batch)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.k4b_ms.append(sum(s.elapsed_time(e) for s, e in events))
        self.last = state
        return state, metrics


def device_breakdown(fn) -> tuple[float, dict]:
    """``fn()`` under ``torch.profiler``: its wall in seconds (synchronised;
    the profiler's overhead in it) and the device time in ms of the CUDA
    kernels and copies it ran, by category: K4b, K4, matrix products
    (cuBLAS/CUTLASS kernels) and the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    ms = collections.Counter()
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.name
        kind = ("K4b" if "bwd::" in name else
                "K4" if "attn_fwd_kernel" in name else
                "matrix products" if any(k in name.lower() for k in (
                    "gemm", "nvjet", "xmma", "cutlass", "cublas")) else
                "other")
        ms[kind] += event.time_range.elapsed_us() / 1e3
    return wall, dict(ms)


def tree_equal(a, b) -> bool:
    """Every leaf of two training trees equal, bit for bit."""
    import torch

    from repro_torch.train.checkpoint import reference_layout

    la, lb = reference_layout(a), reference_layout(b)
    return la.keys() == lb.keys() and all(
        torch.equal(x, y) for k in la for x, y in zip(la[k][0], lb[k][0]))


def scratch_dir() -> Path:
    """Where the training phases write their checkpoints: a directory of
    the checkout that git ignores (``build/``), not the host's temp."""
    path = ROOT / "build"
    path.mkdir(exist_ok=True)
    return path


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def run_training_path(counters, device=None, cfg=None, batch=None, seq=None,
                      steps=TRAIN_STEPS, serve=TRAIN_SERVE):
    """Full-width gemma2_2b (or ``cfg``) trained for ``steps`` steps by
    ``Trainer.run`` under ``run_with_restarts``, from a ``HostBatcher``
    over a ``ShardedCorpus``, 2 microbatches, bfloat16 moments, one
    checkpoint at the last step; the kernel counters of ``counters`` set
    to 0 before the run and read after it. Then: the checkpoint restored
    into a fresh ``TrainState`` leaf-equal; the restored parameters,
    served, give the in-memory parameters' greedy tokens; 3 more steps on
    one fixed batch lower its loss. Returns the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import CorpusSpec, HostBatcher, ShardedCorpus
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import (
        Trainer, TrainerConfig, init_train_state, load_checkpoint,
        make_eval_step, make_train_step, run_with_restarts,
    )

    cfg = cfg or get_config(TRAIN_ARCH)
    batch, seq = batch or TRAIN_BATCH, seq or TRAIN_SEQ
    bundle = build_model(cfg, device)
    dev = bundle.device
    tcfg = TrainConfig(**TRAIN_CONFIG)
    corpus = ShardedCorpus(CorpusSpec(
        num_shards=2, tokens_per_shard=(steps + 2) * batch * (seq + 1),
        seed=TRAIN_SEED))
    shards = [corpus.shard_tokens(i) for i in range(2)]
    out = {"arch": cfg.name, "steps": steps, "batch": batch, "seq": seq,
           "microbatches": tcfg.microbatches}
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        lines = []
        trainer = Trainer(
            bundle, tcfg, HostBatcher(shards, batch_size=batch, seq_len=seq),
            TrainerConfig(ckpt_dir=tmp, ckpt_every=steps, log_every=1,
                          keep_last=1),
            log_fn=lambda m: (lines.append(m), log(m)))
        clock = StepClock(trainer.train_step)
        trainer.train_step = clock
        saves = []
        save = trainer._save

        def timed_save(state, step):
            torch.cuda.synchronize()
            t = time.perf_counter()
            save(state, step)
            saves.append(time.perf_counter() - t)

        trainer._save = timed_save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in counters.values():
            w.launches = 0
        routed = {n: collections.Counter(w.route_launches)
                  for n, w in counters.items() if hasattr(w, "route_launches")}
        t0 = time.perf_counter()
        final, restarts = run_with_restarts(
            lambda: trainer.run(steps).final_step)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in counters.items()}
        routes = {n: by_route(collections.Counter(counters[n].route_launches)
                              - before) for n, before in routed.items()}
        peak = torch.cuda.max_memory_allocated()
        losses = [float(m.split("loss ")[1].split()[0]) for m in lines
                  if m.startswith("[trainer] step")]
        attn_layers = sum(k in ("attn", "local_attn")
                          for k in layer_kinds(cfg))
        want = {"flash_attention": 2 * steps * tcfg.microbatches * attn_layers,
                "flash_attention_bwd": steps * tcfg.microbatches * attn_layers}
        tokens = batch * seq
        step_s = clock.seconds
        steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
        k4b_share = statistics.median(
            ms / 1e3 / s for ms, s in zip(clock.k4b_ms[1:] or clock.k4b_ms,
                                          step_s[1:] or step_s))
        log(f"training path {cfg.name}: {steps} steps of {batch} x {seq} "
            f"tokens in {tcfg.microbatches} microbatches, wall {wall:.2f}s "
            f"(the final checkpoint's save included); step seconds "
            f"{[round(t, 3) for t in step_s]}, {tokens / steady:.0f} "
            f"tokens/s after the first; K4b {[round(t, 1) for t in clock.k4b_ms]}"
            f" ms a step, {100 * k4b_share:.1f} % of it; losses {losses}; "
            f"launches {launches} (counted {want}), by route {routes}; peak "
            f"device memory {peak / 2**30:.2f} GiB")
        if (final, restarts) != (steps, 0) or len(losses) != steps or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"training path: final step {final}, {restarts} restarts, "
                 f"losses {losses} (finite and falling wanted)")
        if launches != want:
            fail(f"training path: launches {launches}, not {want} (2 K4 "
                 "forwards a layer a microbatch under remat, one K4b)")
        for name, r in routes.items():
            wrong = {k: n for k, n in r.items()
                     if DTYPE_ROUTE.get(k.split("/")[0]) != k.split("/")[1]}
            if wrong or sum(r.values()) != launches[name]:
                fail(f"training path: {name} launches by route {r}")

        # the checkpoint, restored into a fresh state
        trained = clock.last
        ckpt_dir = Path(tmp) / f"step_{steps:08d}"
        nbytes = dir_bytes(ckpt_dir)
        fresh = init_train_state(bundle, tcfg, torch.Generator(
            device=dev).manual_seed(TRAIN_SEED + 1))
        torch.cuda.synchronize()
        t = time.perf_counter()
        load_checkpoint(tmp, {"params": fresh.params, "opt": fresh.opt})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if not tree_equal({"params": fresh.params, "opt": fresh.opt},
                          {"params": trained.params, "opt": trained.opt}):
            fail("training path: the restored state differs from the trained "
                 "one")
        log(f"training path: the step-{steps} checkpoint, {nbytes} bytes, "
            f"saved in {saves[-1]:.2f}s and restored into a fresh TrainState "
            f"in {load_s:.2f}s, every leaf equal")
        del fresh
        torch.cuda.empty_cache()
        with phase("elastic restore onto a one-rank mesh"):
            elastic = elastic_restore_check(tmp, bundle, trained, tcfg,
                                            load_s, device)

        # serving from it
        n_req, prompt, new = serve
        rng = np.random.default_rng(TRAIN_SEED)
        reqs = list(rng.integers(0, cfg.vocab_size, (n_req, prompt))
                    .astype(np.int32))
        served = bundle.init(torch.Generator(device=dev).manual_seed(0))
        load_checkpoint(tmp, {"params": served})
        config = ServeConfig(max_new_tokens=new)
        from_ckpt = np.stack(ServeEngine(bundle, served, config)
                             .serve_queue(reqs, slots=n_req))
        in_memory = np.stack(ServeEngine(bundle, trained.params, config)
                             .serve_queue(reqs, slots=n_req))
        if not np.array_equal(from_ckpt, in_memory):
            fail("training path: the checkpoint's parameters serve other "
                 "tokens than the trained ones in memory")
        log(f"training path: {n_req} requests x {prompt} tokens served from "
            f"the restored checkpoint, {new} greedy tokens each, equal to "
            f"the in-memory parameters'; first: {from_ckpt[0].tolist()}")
        del served

    # 3 more steps on one fixed batch lower its loss
    fixed = HostBatcher(shards, batch_size=batch, seq_len=seq).take(1)[0]
    fixed = {"tokens": torch.from_numpy(fixed.tokens),
             "targets": torch.from_numpy(fixed.targets)}
    evaluate = make_eval_step(bundle)
    step = make_train_step(bundle, tcfg)
    state = trained
    before = float(evaluate(state.params, fixed)["loss"])
    for _ in range(2):
        state, _ = step(state, fixed)
    # the third under torch.profiler: where a step's device time goes
    traced_s, device_ms = device_breakdown(lambda: step(state, fixed))
    after = float(evaluate(state.params, fixed)["loss"])
    busy = sum(device_ms.values())
    log(f"training path: one fixed batch's loss {before:.4f} -> {after:.4f} "
        f"after 3 more steps; the third under torch.profiler: "
        f"{busy:.1f} ms of device time in {1e3 * traced_s:.1f} ms of wall "
        f"(idle {100 * (1 - busy / (1e3 * traced_s)):.1f} %), by kind "
        + json.dumps({k: round(v, 1) for k, v in sorted(device_ms.items())}))
    if not after < before:
        fail(f"training path: 3 steps on a fixed batch did not lower its "
             f"loss ({before} -> {after})")
    k4b_ms = clock.k4b_ms
    del state, trained, clock, trainer
    torch.cuda.empty_cache()
    return {**out, "wall_s": wall, "step_s": step_s,
            "tokens_per_s": tokens / steady, "losses": losses,
            "k4b_ms_per_step": k4b_ms, "k4b_share": k4b_share, "launches": launches, "routes": routes,
            "peak_gib": peak / 2**30, "checkpoint_bytes": nbytes,
            "save_s": saves[-1], "load_s": load_s, "elastic": elastic,
            "fixed_batch_loss": [before, after],
            "traced_step": {"wall_ms": 1e3 * traced_s,
                            "device_ms": device_ms}}


def elastic_restore_check(ckpt_dir, bundle, trained, tcfg, load_s,
                          device=None):
    """The training path's checkpoint restored by ``load_checkpoint(...,
    shardings=)`` onto a one-rank (1, 1) ("data", "model") mesh (NCCL on
    the card): the parameters and both moments, each leaf a DTensor on
    that mesh with the placements ``Partitioner(mesh).tree_shardings``
    gives it, equal to the trained state's leaf (the reference's stacked
    layout); the load seconds beside the in-place restore's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.partitioning import Partitioner
    from repro_torch.models.layers import abstract_params, tree_leaves
    from repro_torch.train import load_checkpoint

    mesh = make_test_mesh((1, 1), ("data", "model"), device)
    moments = abstract_params(bundle.specs, getattr(torch, tcfg.opt_state_dtype))
    like = {"params": bundle.abstract(), "opt": {"mu": moments, "nu": moments}}
    axes = {"params": bundle.axes, "opt": {"mu": bundle.axes, "nu": bundle.axes}}
    shardings = Partitioner(mesh).tree_shardings(like, axes)
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored, extra = load_checkpoint(ckpt_dir, like, shardings=shardings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    want = reference_layout_of(trained)
    got = dict(tree_leaves(restored))
    placed = dict(tree_leaves(shardings))
    if set(got) != set(want):
        fail(f"elastic restore: leaves {sorted(set(got) ^ set(want))[:4]} "
             "differ from the trained state's")
    nbytes = 0
    for key, leaf in got.items():
        layers, stacked = want[key]
        ref = torch.stack(layers) if stacked else layers[0]
        if not (isinstance(leaf, DTensor) and leaf.device_mesh is mesh
                and tuple(leaf.placements) == placed[key].placements
                and torch.equal(leaf.to_local(), ref.detach())):
            fail(f"elastic restore: {key} is not the trained leaf as a "
                 f"DTensor on the mesh with placements "
                 f"{placed[key].placements}")
        nbytes += leaf.to_local().numel() * leaf.to_local().element_size()
    log(f"elastic restore: {len(got)} leaves ({nbytes} bytes) onto a "
        f"one-rank {dist.get_backend()} mesh (1, 1) as DTensors with the "
        f"rules' placements in {seconds:.2f}s (the in-place restore "
        f"{load_s:.2f}s), every leaf equal to the trained state's; data "
        f"cursor {extra.get('data')}")
    del restored, got
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"leaves": len(want), "bytes": nbytes, "load_s": seconds,
            "in_place_load_s": load_s}


def run_mesh_train_step(counters, device=None, cfg=None, batch=None,
                        seq=None):
    """Full-width gemma2_2b (or ``cfg``) through ``make_train_step(...,
    mesh=make_test_mesh((1, 1, 1), ("pod", "data", "model")),
    pod_axis="pod")`` for 2 steps on the training path's first two batches
    (its corpus, 2 microbatches, remat, bfloat16 moments), against 2 steps
    of the mesh-less step from the same initial state: the two final
    states bit-identical (a one-rank reduction changes no bit), K4 and
    K4b on the tensor cores, seconds a step logged. Then the cross-pod
    mean of one full-width step's gradients over a one-rank NCCL pod
    group (``train_step.compressed_pod_mean``: quantise, all-gather,
    dequantise, average) bit for bit against the same arithmetic in plain
    torch, and ``q·scale + new residual`` equal to ``grad + residual``
    within float32 rounding."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import CorpusSpec, HostBatcher, ShardedCorpus
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.partitioning import Partitioner
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.checkpoint import reference_key
    from repro_torch.train.train_step import (
        _grads_and_metrics, compressed_pod_mean, shard_train_state,
    )

    cfg = cfg or get_config(TRAIN_ARCH)
    batch, seq = batch or TRAIN_BATCH, seq or TRAIN_SEQ
    steps = 2
    bundle = build_model(cfg, device)
    dev = bundle.device
    tcfg = TrainConfig(**TRAIN_CONFIG)
    corpus = ShardedCorpus(CorpusSpec(
        num_shards=2, tokens_per_shard=(TRAIN_STEPS + 2) * batch * (seq + 1),
        seed=TRAIN_SEED))
    batcher = HostBatcher([corpus.shard_tokens(i) for i in range(2)],
                          batch_size=batch, seq_len=seq)
    batches = [{"tokens": torch.from_numpy(b.tokens),
                "targets": torch.from_numpy(b.targets)}
               for b in batcher.take(steps)]

    def trained(step_fn, mesh=None):
        state = init_train_state(bundle, tcfg, torch.Generator(
            device=dev).manual_seed(TRAIN_SEED))
        if mesh is not None:    # parameters and moments as the rules' shards
            state = shard_train_state(state, bundle, mesh)
        clock = StepClock(step_fn)
        metrics = [clock(state, b)[1] for b in batches]
        return clock.last, metrics, clock.seconds

    plain, plain_metrics, plain_s = trained(make_train_step(bundle, tcfg))
    snapshot = {k: [t.detach().cpu() for t in ts] for k, (ts, _) in
                reference_layout_of(plain).items()}
    del plain
    torch.cuda.empty_cache()

    mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"), device)
    for w in counters.values():
        w.launches = 0
    routed = {n: collections.Counter(w.route_launches)
              for n, w in counters.items() if hasattr(w, "route_launches")}
    grad_shardings = Partitioner(mesh).tree_shardings(bundle.abstract(),
                                                      bundle.axes)
    state, metrics, seconds = trained(
        make_train_step(bundle, tcfg, mesh=mesh, pod_axis="pod",
                        grad_shardings=grad_shardings), mesh)
    launches = {n: w.launches for n, w in counters.items()}
    routes = {n: by_route(collections.Counter(counters[n].route_launches)
                          - before) for n, before in routed.items()}
    attn_layers = sum(k in ("attn", "local_attn") for k in layer_kinds(cfg))
    want = {"flash_attention": 2 * steps * tcfg.microbatches * attn_layers,
            "flash_attention_bwd": steps * tcfg.microbatches * attn_layers}
    sharded = all(isinstance(t, DTensor) for ts, _ in
                  reference_layout_of(state).values() for t in ts)
    same = all(torch.equal(t.full_tensor().cpu(), snapshot[k][i])
               for k, (ts, _) in reference_layout_of(state).items()
               for i, t in enumerate(ts)) and all(
        torch.equal(a[k].cpu(), b[k].cpu())
        for a, b in zip(metrics, plain_metrics) for k in a)
    losses = [float(m["loss"]) for m in metrics]
    log(f"mesh train step {cfg.name}: {steps} steps of {batch} x {seq} tokens "
        f"({tcfg.microbatches} microbatches) on a one-rank "
        f"{dist.get_backend()} mesh (pod, data, model) = (1, 1, 1): step "
        f"seconds {[round(t, 3) for t in seconds]} (mesh-less "
        f"{[round(t, 3) for t in plain_s]}), losses {losses}; launches "
        f"{launches} (counted {want}), by route {routes}; parameters and "
        f"moments {'held' if sharded else 'NOT held'} as DTensors of the "
        f"rules' layout (grad_shardings= pinned); the final state "
        f"and metrics {'bit-identical' if same else 'NOT bit-identical'} to "
        f"the mesh-less step's")
    if launches != want:
        fail(f"mesh train step: launches {launches}, not {want}")
    for name, r in routes.items():
        wrong = {k: n for k, n in r.items()
                 if DTYPE_ROUTE.get(k.split("/")[0]) != k.split("/")[1]}
        if wrong or sum(r.values()) != launches[name]:
            fail(f"mesh train step: {name} launches by route {r}")
    if not sharded:
        fail("mesh train step: a parameter or moment is not a DTensor of "
             "the rules' layout")
    if not same:
        fail("mesh train step: the state after 2 steps on the one-rank mesh "
             "differs from the mesh-less step's")
    del snapshot

    # the cross-pod mean of one full-width step's gradients, pod group of 1
    grads, _ = _grads_and_metrics(bundle, tcfg, state.params, batches[0])
    grads = {n: g.full_tensor() for n, g in grads.items()}
    del state
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    residual = {n: 1e-3 * g.float().std() * torch.randn(
        g.shape, generator=gen, device=dev) for n, g in grads.items()}
    before = {n: r.clone() for n, r in residual.items()}
    group = mesh.get_group("pod")
    torch.cuda.synchronize()
    t = time.perf_counter()
    mean = compressed_pod_mean(grads, residual, group, 1)
    torch.cuda.synchronize()
    mean_s = time.perf_counter() - t
    leaves: dict = {}
    for name in grads:
        leaves.setdefault(reference_key(name), []).append(name)
    exact, worst = True, 0.0
    for key, names in leaves.items():
        g32 = torch.stack([grads[n] for n in names]).float() + torch.stack(
            [before[n] for n in names])
        scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        for i, n in enumerate(names):
            exact &= torch.equal(mean[n], deq[i])
            back = deq[i] + residual[n]
            worst = max(worst, float(((back - g32[i]).abs()
                                      / g32.abs().max()).max()))
        del g32, q, deq
    log(f"cross-pod mean over a one-rank {dist.get_backend()} pod group: "
        f"{len(grads)} gradients in {len(leaves)} reference leaves (one "
        f"scale a leaf) quantised, all-gathered, dequantised and averaged "
        f"in {mean_s:.3f}s, {'bit-exact' if exact else 'NOT bit-exact'} "
        f"with the same arithmetic in plain torch; q x scale + new residual "
        f"against grad + residual: worst |diff| {worst:.3g} of the leaf's "
        f"largest")
    if not exact:
        fail("cross-pod mean differs from its plain arithmetic")
    if worst > 2.0 ** -22:
        fail(f"q x scale + new residual differs from grad + residual by "
             f"{worst} of the leaf's largest (float32 rounding wanted)")
    del grads, residual, before, mean
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"steps": steps, "step_s": seconds, "plain_step_s": plain_s,
            "losses": losses, "launches": launches, "routes": routes,
            "bit_identical": same, "sharded": sharded, "pod_mean_s": mean_s,
            "pod_mean_exact": exact, "residual_identity": worst}


def dryrun_command(*args) -> list:
    return [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
            *args]


def dryrun_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return env


#: the processes this script starts, stopped when it ends
CHILDREN: list = []


def start_dryrun(out: Path, name: str, *args) -> tuple:
    """``python -m repro_torch.launch.dryrun *args`` started in a process
    of its own (the fake default group is global to its process), its
    output to ``out/<name>.log``; returns (process, log path)."""
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.log"
    with open(path, "w") as f:
        proc = subprocess.Popen(dryrun_command(*args, "--out", str(out)),
                                env=dryrun_env(), cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT, text=True)
    CHILDREN.append(proc)
    return proc, path


def finish_dryrun(proc, path: Path, what: str) -> None:
    """Wait for a dry-run started by :func:`start_dryrun`, log its cell
    lines, and fail unless it exited 0."""
    proc.wait(timeout=600)
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith("[dryrun]"):
            log(line)
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}:\n{text[-4000:]}")


def start_dryrun_cells(out: Path) -> list:
    """The production-mesh dry-run of ``gemma2_2b``, one process a cell
    of ``DRYRUN_CELLS``, all started together."""
    return [(shape, mesh, *start_dryrun(
        out, f"{shape}_{mesh}", "--arch", SERVE_ARCH, "--shape", shape,
        "--mesh", mesh)) for shape, mesh in DRYRUN_CELLS]


def run_dryrun_cells(out: Path, procs: list) -> dict:
    """The cells of :func:`start_dryrun_cells`: every process must exit
    0 with its cells ``ok``. Logs each cell's line and returns the
    cells' records (predictions at H100 data-sheet constants)."""
    cells = {}
    for shape, mesh, proc, path in procs:
        finish_dryrun(proc, path, f"dry-run {SERVE_ARCH} {shape} {mesh}")
        for name in (("single", "multi") if mesh == "both" else (mesh,)):
            cell = json.loads((out / f"{SERVE_ARCH}__{shape}__{name}.json")
                              .read_text())
            if cell["status"] != "ok":
                fail(f"dry-run cell {shape} {name}: {cell['status']}")
            roof = cell["roofline"]
            log(f"dry-run {SERVE_ARCH} {shape} on {name} ({roof['chips']} "
                f"ranks), predicted at H100 data-sheet constants: "
                f"{roof['flops_per_device'] / 1e12:.3f} TFLOP and "
                f"{roof['hbm_bytes_per_device'] / 1e9:.2f} GB of HBM a "
                f"device, collectives {cell['collectives']['total'] / 1e9:.3f}"
                f" GB in {cell['collectives']['count']}, peak "
                f"{cell['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB a "
                f"device, bound {roof['t_bound_s'] * 1e3:.2f} ms "
                f"({roof['bottleneck']})")
            cells[f"{shape} {name}"] = {
                "flops_per_device": roof["flops_per_device"],
                "hbm_bytes_per_device": roof["hbm_bytes_per_device"],
                "collective_bytes": cell["collectives"]["total"],
                "collectives": cell["collectives"]["count"],
                "peak_bytes": cell["memory"]["peak_estimate_bytes"],
                "t_bound_s": roof["t_bound_s"],
                "bottleneck": roof["bottleneck"]}
    return cells


def start_card_cell(out: Path) -> tuple:
    """The dry-run's cell of phase 13's training configuration on the
    one-rank (1, 1, 1) mesh, started (:func:`start_dryrun`)."""
    tcfg = TRAIN_CONFIG
    return start_dryrun(
        out, "card_cell", "--arch", TRAIN_ARCH, "--shape", "train_4k",
        "--mesh", "one", "--shape-set", f"seq_len={TRAIN_SEQ}",
        f"global_batch={TRAIN_BATCH}", "--train-set",
        f"microbatches={tcfg['microbatches']}",
        f"opt_state_dtype={tcfg['opt_state_dtype']}")


def dryrun_against_the_card(counters, out: Path, cell_proc,
                            device=None) -> dict:
    """The dry-run's cell of phase 13's training configuration (full-width
    ``gemma2_2b``, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, its
    microbatches, remat and bfloat16 moments, on the one-rank (1, 1, 1)
    mesh) against one real step of it on the card, the state as the
    rules' DTensors on a one-rank NCCL mesh: the dry-run's per-device FLOP
    count must equal ``FlopCounterMode``'s count of the real step; its
    predicted peak must fall within ``DRYRUN_PEAK_BAND`` of the step's
    measured peak (``torch.cuda.max_memory_allocated`` from before the
    state was made); and two more steps, synchronised and timed, must
    take at least the cell's ``t_bound``. K4's and K4b's launches are
    counted a step."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import CorpusSpec, HostBatcher, ShardedCorpus
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.partitioning import Partitioner
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.train_step import shard_train_state

    tcfg = TrainConfig(**TRAIN_CONFIG)
    cfg = get_config(TRAIN_ARCH)
    bundle = build_model(cfg, device)
    dev = bundle.device
    steps = 3
    corpus = ShardedCorpus(CorpusSpec(
        num_shards=2, tokens_per_shard=(steps + 2) * TRAIN_BATCH
        * (TRAIN_SEQ + 1), seed=TRAIN_SEED))
    batcher = HostBatcher([corpus.shard_tokens(i) for i in range(2)],
                          batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batches = [{"tokens": torch.from_numpy(b.tokens).to(dev, torch.int32),
                "targets": torch.from_numpy(b.targets).to(dev, torch.int32)}
               for b in batcher.take(steps)]
    finish_dryrun(*cell_proc, "the dry-run of the card's cell")
    mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"), device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for b in batches for t in b.values())
    state = shard_train_state(init_train_state(bundle, tcfg, torch.Generator(
        device=dev).manual_seed(TRAIN_SEED)), bundle, mesh)
    step = make_train_step(bundle, tcfg, mesh=mesh, pod_axis="pod",
                           grad_shardings=Partitioner(mesh).tree_shardings(
                               bundle.abstract(), bundle.axes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counters.values():
        w.launches = 0
    with FlopCounterMode(display=False) as flops:
        state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in counters.items()}
    # the step's peak over the state and one batch (the others held aside)
    peak = torch.cuda.max_memory_allocated() - base - sum(
        t.numel() * t.element_size() for b in batches[1:]
        for t in b.values())
    seconds = []
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    cell = json.loads((out / f"{TRAIN_ARCH}__train_4k__one.json").read_text())
    roof, memory = cell["roofline"], cell["memory"]
    counted = flops.get_total_flops()
    ratio = memory["peak_estimate_bytes"] / peak
    measured = min(seconds)
    layers = sum(k in ("attn", "local_attn") for k in layer_kinds(cfg))
    want = {"flash_attention": 2 * tcfg.microbatches * layers,
            "flash_attention_bwd": tcfg.microbatches * layers}
    log(f"dry-run against the card, {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens ({tcfg.microbatches} microbatches, remat, "
        f"{tcfg.opt_state_dtype} moments) on a one-rank "
        f"{dist.get_backend()} mesh (1, 1, 1): FLOPs predicted "
        f"{roof['flops_per_device']:.0f}, counted on the card by "
        f"FlopCounterMode {counted} "
        f"({'equal' if counted == roof['flops_per_device'] else 'NOT equal'}"
        f"); "
        f"peak predicted {memory['peak_estimate_bytes'] / 2**30:.3f} GiB, "
        f"measured {peak / 2**30:.3f} GiB (predicted / measured "
        f"{ratio:.4f}); step seconds {[round(t, 4) for t in seconds]}, "
        f"t_bound {roof['t_bound_s']:.4f} s ({roof['bottleneck']}; compute "
        f"{roof['t_compute_s']:.4f}, memory {roof['t_memory_s']:.4f}), "
        f"measured / t_bound {measured / roof['t_bound_s']:.3f}; launches "
        f"in the counted step {launches} (counted {want})")
    if counted != roof["flops_per_device"]:
        fail(f"dry-run against the card: FLOPs {roof['flops_per_device']} "
             f"predicted, {counted} counted on the card")
    if abs(ratio - 1) > DRYRUN_PEAK_BAND:
        fail(f"dry-run against the card: peak predicted / measured {ratio}, "
             f"outside 1 +- {DRYRUN_PEAK_BAND}")
    if measured < roof["t_bound_s"]:
        fail(f"dry-run against the card: a step took {measured} s, under "
             f"the bound {roof['t_bound_s']} s: the count is wrong")
    if launches != want:
        fail(f"dry-run against the card: launches {launches}, not {want}")
    del state, step, batches
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"flops_predicted": roof["flops_per_device"],
            "flops_counted": counted,
            "peak_predicted_bytes": memory["peak_estimate_bytes"],
            "peak_measured_bytes": peak, "peak_ratio": ratio,
            "step_s": seconds, "t_bound_s": roof["t_bound_s"],
            "bottleneck": roof["bottleneck"],
            "t_compute_s": roof["t_compute_s"],
            "t_memory_s": roof["t_memory_s"],
            "measured_over_bound": measured / roof["t_bound_s"],
            "launches": launches}


def reference_layout_of(state):
    """A train state's parameters and moments in the reference's layout."""
    from repro_torch.train.checkpoint import reference_layout

    return reference_layout({"params": state.params, "opt": {
        "mu": state.opt.mu, "nu": state.opt.nu}})


def crash_restart_check(device=None, cfg=None, spec=None):
    """gemma2_2b at full width and reduced depth (``CRASH``): a run that
    crashes at step ``at`` and is restarted by ``run_with_restarts`` from
    its latest checkpoint (one every ``every`` steps) ends with the
    parameters and moments of an uninterrupted run, bit for bit; its final
    checkpoint, through ``checkpoint_metainfo`` and ``restore_from_bundle``,
    comes back byte for byte. Returns the check's numbers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import CorpusSpec, HostBatcher, ShardedCorpus
    from repro_torch.models import build_model
    from repro_torch.train import (
        FailurePlan, Trainer, TrainerConfig, checkpoint_metainfo,
        restore_from_bundle, run_with_restarts,
    )

    spec = spec or CRASH
    cfg = cfg or dataclasses.replace(get_config(TRAIN_ARCH),
                                     num_layers=spec["layers"])
    bundle = build_model(cfg, device)
    tcfg = TrainConfig(**TRAIN_CONFIG)
    steps, batch, seq = spec["steps"], spec["batch"], spec["seq"]
    corpus = ShardedCorpus(CorpusSpec(
        num_shards=2, tokens_per_shard=(steps + 2) * batch * (seq + 1),
        seed=TRAIN_SEED))
    shards = [corpus.shard_tokens(i) for i in range(2)]
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        runs = {}
        for name, plan in (("uninterrupted", None),
                           ("crashed", FailurePlan(
                               crash_at_steps=(spec["at"],)))):
            lines = []
            trainer = Trainer(
                bundle, tcfg, HostBatcher(shards, batch_size=batch,
                                          seq_len=seq),
                TrainerConfig(ckpt_dir=str(Path(tmp) / name),
                              ckpt_every=spec["every"], log_every=1,
                              keep_last=1),
                failure_plan=plan, log_fn=lines.append)
            clock = StepClock(trainer.train_step)
            trainer.train_step = clock
            t0 = time.perf_counter()
            final, restarts = run_with_restarts(
                lambda: trainer.run(steps).final_step)
            runs[name] = (clock.last, final, restarts,
                          time.perf_counter() - t0, lines)
        (a, fa, ra, wa, _), (b, fb, rb, wb, lines) = runs.values()
        if (fa, ra, fb, rb) != (steps, 0, steps, 1) or (
                f"[trainer] resumed from step {spec['at'] - spec['at'] % spec['every']}"
                not in lines):
            fail(f"crash and restart: final steps {fa}, {fb}, restarts {ra}, "
                 f"{rb}; log {lines}")
        if not tree_equal({"params": a.params, "opt": a.opt},
                          {"params": b.params, "opt": b.opt}):
            fail("crash and restart: the restarted run ends with other "
                 "parameters or moments than the uninterrupted one")
        del a, b, runs
        torch.cuda.empty_cache()
        src = Path(tmp) / "crashed"
        t = time.perf_counter()
        mi, payload = checkpoint_metainfo(src, steps)
        out = restore_from_bundle(mi, dict(mi.split_pieces(payload)),
                                  Path(tmp) / "bundle")
        bundle_s = time.perf_counter() - t
        original = src / f"step_{steps:08d}"
        names = sorted(f.name for f in original.iterdir())
        if names != sorted(f.name for f in out.iterdir()) or any(
                (original / n).read_bytes() != (out / n).read_bytes()
                for n in names):
            fail("crash and restart: the checkpoint came back from its "
                 "bundle changed")
        log(f"crash and restart: {cfg.name} at {cfg.num_layers} layers, "
            f"{steps} steps of {batch} x {seq} tokens, a checkpoint every "
            f"{spec['every']}: crashed at step {spec['at']}, resumed, and "
            f"ended bit-identical to the uninterrupted run ({wa:.1f}s and "
            f"{wb:.1f}s); its step-{steps} checkpoint ({len(payload)} bytes "
            f"in {len(names)} files, {mi.num_pieces} pieces, info-hash "
            f"{mi.info_hash_hex[:16]}...) through checkpoint_metainfo and "
            f"restore_from_bundle byte-identical in {bundle_s:.1f}s")
        return {"layers": cfg.num_layers, "steps": steps,
                "bit_identical": True, "bundle_bytes": len(payload),
                "uninterrupted_s": wa, "crashed_s": wb,
                "bundle_round_trip_s": bundle_s}


def run_launchers(device=None):
    """``python -m repro_torch.launch.train`` for a few steps into a
    temporary directory, then ``python -m repro_torch.launch.serve
    --ckpt-dir`` and ``python -m repro_torch.launch.elastic --ckpt-dir``
    on it, on the card at their reduced config (``device``, if given, is
    passed on as ``--device``); each must exit 0 and print its ``done
    step=``, ``restored from`` or ``resharded ... data cursor`` line."""
    extra = [] if device is None else ["--device", str(device)]
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = {}
        for name, argv, want in (
                ("train", ["repro_torch.launch.train", "--arch", TRAIN_ARCH,
                           "--steps", "10", "--global-batch", "4",
                           "--seq-len", "64", "--ckpt-dir", tmp],
                 "done step=10 restarts=0"),
                ("serve", ["repro_torch.launch.serve", "--arch", TRAIN_ARCH,
                           "--ckpt-dir", tmp], f"restored from {tmp}"),
                ("elastic", ["repro_torch.launch.elastic", "--arch",
                             TRAIN_ARCH, "--ckpt-dir", tmp], "data cursor")):
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *argv, *extra],
                                  cwd=ROOT,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            out[name] = time.perf_counter() - t
            log(f"launch.{name} (reduced config, on the card) exited "
                f"{proc.returncode} in {out[name]:.1f}s:\n{proc.stdout.strip()}")
            if proc.returncode != 0 or want not in proc.stdout or (
                    name == "elastic" and "resharded" not in proc.stdout):
                fail(f"launch.{name}: exit {proc.returncode}, no '{want}' "
                     f"line:\n{proc.stdout}\n{proc.stderr}")
        return out


# ------------------------------------------------------------------ walkthroughs


@contextlib.contextmanager
def attention_calls(record, fwd="flash_attention_cuda",
                    bwd="flash_attention_bwd_cuda"):
    """Keep in ``record`` the first call of each signature (kernel,
    shapes, dtype, mask arguments) that the attention op's dispatch makes
    to K4 (``fwd``) and K4b (``bwd``) inside the block: its inputs and its
    outputs, cloned, so that the launches the path made can be held
    against the plain version afterwards. The kernels run and count as
    they would without it; later calls of a kept signature are not
    copied."""
    from repro_torch.kernels.attention import ops

    kernels = {"K4": getattr(ops, fwd), "K4b": getattr(ops, bwd)}

    def keeping(name):
        def call(*args, **kw):
            result = kernels[name](*args, **kw)
            key = (name, tuple((tuple(t.shape), str(t.dtype)[6:])
                               for t in args[:3]), tuple(sorted(kw.items())))
            if key not in record:
                outs = result if isinstance(result, tuple) else (result,)
                record[key] = ([t.detach().clone() for t in args], dict(kw),
                               [t.detach().clone() for t in outs])
            return result
        return call

    with swapped(ops, fwd, keeping("K4")), swapped(ops, bwd, keeping("K4b")):
        yield


def hold_attention_calls(k4, record, what) -> list:
    """Each call ``attention_calls`` kept, against the plain version on
    its own inputs. K4: its output (and log-sum-exp, where it wrote one)
    elementwise within ``K4_TOL``; in float32 the bf16-probability control
    must break that tolerance somewhere, in bfloat16 the output must also
    hold ``K4_REL_L2``, which that control must miss (phase 5's bands).
    K4b: its three gradients within ``K4B_REL_L2`` for their dtype, which
    K4b's plain version with delta zero (float32) or with bf16 P and dS
    (bfloat16) must miss; the plain version without the softcap's
    derivative is logged where a softcap is on. Fails on any miss; returns
    one reading a call."""
    import torch

    def outside(got, want, atol, rtol) -> int:
        return int((~torch.isclose(got.float(), want.float(), atol=atol,
                                   rtol=rtol)).sum())

    readings = []
    for (name, shapes, _), (args, kw, outs) in record.items():
        dt = shapes[0][1]
        atol, rtol = K4_TOL[dt]
        call = f"{what}: {name} {dt} q/k/v {[s for s, _ in shapes]} {kw}"
        mask = {n: x for n, x in kw.items() if n != "return_lse"}
        if name == "K4":
            q, k, v = args
            want = k4.attention_bhsd_ref(q, k, v, return_lse=True, **mask)
            want = want[:len(outs)]
            control = attention_bf16_probs(q, k, v, **mask)
            if dt == "float32":
                band = None
                controls = {"bf16 probabilities: values outside the "
                            "tolerance": outside(control, want[0], atol,
                                                 rtol)}
            else:
                band = K4_REL_L2
                controls = {"bf16 probabilities": rel_l2(control, want[0])}
            del control
            rels = [rel_l2(outs[0], want[0])]
        else:
            want = k4.attention_bwd_ref(*args, **kw)
            band = K4B_REL_L2[dt]
            if dt == "float32":
                faults = ["delta zero"] + (["no softcap derivative"]
                                           if kw.get("softcap") else [])
                bad = {f: attention_bwd_faulty(*args, fault=f, **kw)
                       for f in faults}
            else:
                bad = {"bf16 P and dS": k4.attention_bwd_rounded_ref(
                    *args, terms=1, **kw)}
            controls = {f: max(rel_l2(x, y) for x, y in zip(g, want))
                        for f, g in bad.items()}
            del bad
            rels = [rel_l2(g, w) for g, w in zip(outs, want)]
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(outs, want))
        finite = all(bool(torch.isfinite(g).all()) for g in outs)
        off = (sum(outside(g, w, atol, rtol) for g, w in zip(outs, want))
               if name == "K4" else 0)
        reading = {"call": call, "max_abs_err": err, "rel_l2": rels,
                   "band": band, "controls": controls}
        log(f"{call}: max |diff| {err:.3g}"
            + (f", {off} values outside atol {atol:.3g} rtol {rtol:.3g}"
               if name == "K4" else "")
            + f"; relative L2 {[float(f'{r:.4g}') for r in rels]}"
            + (f" (band {band:.4g})" if band else "") + "; controls "
            + json.dumps({n: float(f"{c:.4g}") for n, c in controls.items()}))
        if not finite or off:
            fail(f"{call}: {off} values outside atol {atol} rtol {rtol} of "
                 f"the plain version or not finite (max |diff| {err})")
        if band is None:
            if not all(controls.values()):
                fail(f"{call}: the bf16-probability control holds the "
                     f"tolerance atol {atol} rtol {rtol}")
            readings.append(reading)
            continue
        if max(rels) > band:
            fail(f"{call}: relative L2 {rels} above {band}")
        for n, c in controls.items():
            if n != "no softcap derivative" and c <= band:
                fail(f"{call}: the control '{n}' ({c}) is inside the band "
                     f"{band}")
        readings.append(reading)
    return readings


@contextlib.contextmanager
def timed_steps(times):
    """Append to ``times`` the seconds of each train step that a
    ``Trainer`` built inside the block takes, the card synchronised
    before and after it, so that a step's time holds its own device work
    and nothing of the data loading or the checkpoints around it."""
    import torch

    from repro_torch.train import trainer

    inner = trainer.make_train_step

    def make(*args, **kw):
        step = inner(*args, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return out
        return timed

    with swapped(trainer, "make_train_step", make):
        yield


def run_walkthroughs(k4, counters, device=None):
    """Phase 16a: the user walkthroughs ``python -m
    repro_torch.examples.<name>`` of ``WALKTHROUGHS``, each run in this
    process (its ``main`` called with the command's arguments, so that the
    kernel counters see its launches), its standard output logged, its
    checkpoints in a temporary directory under ``build/``: ``quickstart``
    must end "all four stages OK" with K4 and K4b launched, ``serve_lm``
    serve every request on the card with K4 launched, the ``paper-100m``
    preset train its steps with K4 and K4b launched (the median train
    step, synchronised, the wall a step with checkpoints included, and the
    first and last logged loss logged), and the ``smoke`` preset with a
    crash injected at step 50 restart once and end at step 100. Each
    run's losses must be finite. The first K4 and K4b call of each
    signature in each run is kept and, after the run, held against the
    plain version (``hold_attention_calls``). Returns {command:
    numbers}."""
    import importlib
    import io
    import math

    extra = [] if device is None else ["--device", str(device)]
    out = {}
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        for i, (name, argv) in enumerate(WALKTHROUGHS):
            command = " ".join([name, *argv])
            if name == "train_lm":
                argv = [*argv, "--ckpt-dir", str(Path(tmp) / f"train_lm{i}")]
            module = importlib.import_module(f"repro_torch.examples.{name}")
            for w in counters.values():
                w.launches = 0
            before = {n: collections.Counter(w.route_launches)
                      for n, w in counters.items()}
            buf, calls, steps = io.StringIO(), {}, []
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf), swapped(
                    tempfile, "tempdir", tmp), attention_calls(calls), \
                    timed_steps(steps):
                result = module.main([*argv, *extra])
            wall = time.perf_counter() - t
            text = buf.getvalue().strip()
            log(f"python -m repro_torch.examples.{command} (in this process) "
                f"in {wall:.1f}s:\n{text}")
            record = {
                "seconds": wall,
                "launches": {n: w.launches for n, w in counters.items()},
                "routes": {n: by_route(collections.Counter(w.route_launches)
                                       - before[n])
                           for n, w in counters.items()}}
            launched = [n for n, c in record["launches"].items() if c]
            want = (["flash_attention"] if name == "serve_lm"
                    else ["flash_attention", "flash_attention_bwd"])
            if sorted(launched) != sorted(want):
                fail(f"walkthrough {command}: launched {record['launches']}, "
                     f"want each of {want} at least once")
            kept = sorted({key[0] for key in calls})
            if kept != (["K4"] if name == "serve_lm" else ["K4", "K4b"]):
                fail(f"walkthrough {command}: the attention op's dispatch "
                     f"made {kept} calls, not every launch it counted")
            record["held"] = hold_attention_calls(k4, calls, command)
            del calls
            if name == "quickstart":
                losses = result.losses
                if text.splitlines()[-1] != "all four stages OK":
                    fail(f"walkthrough {command}: no 'all four stages OK'")
            elif name == "serve_lm":
                losses = None
                if len(result) != 6 or any(len(o) != 12 for o in result):
                    fail(f"walkthrough {command}: served "
                         f"{[len(o) for o in result]} tokens, want 6 x 12")
                where = "cpu" if str(device) == "cpu" else "cuda"
                if f"tok/s on {where}" not in text:
                    fail(f"walkthrough {command}: not served on {where}")
            else:
                losses = result["losses"]
                crash = "--inject-crash-at" in argv
                final = (int(argv[argv.index("--steps") + 1])
                         if "--steps" in argv else module.PRESETS[
                             argv[argv.index("--preset") + 1]]["steps"])
                if (result["final_step"], result["restarts"]) != (
                        final, int(crash)):
                    fail(f"walkthrough {command}: ended at step "
                         f"{result['final_step']} after {result['restarts']} "
                         f"restarts, want {final} after {int(crash)}")
                record.update(final_step=result["final_step"],
                              restarts=result["restarts"],
                              params=result["params"],
                              wall_per_step_s=result["seconds"] / final)
            if steps:
                # the first step builds and loads the kernels
                record.update(train_steps=len(steps),
                              step_ms_median=1e3 * statistics.median(
                                  steps[1:] or steps))
            if losses is not None:
                if not losses or not all(math.isfinite(x) for x in losses):
                    fail(f"walkthrough {command}: losses {losses}")
                record.update(first_loss=losses[0], last_loss=losses[-1])
            log(f"walkthrough {command}: " + json.dumps(record))
            out[command] = record
    return out


# ------------------------------------------------------------------ MoE paths


@contextlib.contextmanager
def moe_routing(record):
    """Append each MoE layer's routing to ``record`` as the model runs it:
    (tokens, each pair's expert, the dropped pairs' count on the device)."""
    from repro_torch.models import moe

    inner = moe._route

    def route(x2d, router, cfg, capacity, ids=None):
        r = inner(x2d, router, cfg, capacity, ids=ids)
        record.append((x2d.shape[0], r.ids, (~r.keep).sum()))
        return r

    with swapped(moe, "_route", route):
        yield


def by_rows(fn):
    """``fn``, an attention with ``attention_bhsd_ref``'s contract, one
    batch row at a time: the same values with a quarter of the float32
    temporaries at the MoE prefill's four rows (three of them 3 GiB at
    dbrx's (4, 48, 2048, 2048) scores)."""
    import torch

    def run(q, k, v, **kw):
        return torch.cat([fn(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
                          for i in range(q.shape[0])])

    return run


def moe_plain(kernels):
    """The plain attention in K4's place, by rows (the MoE archs run no
    other kernel)."""
    return sequence_attention(by_rows(kernels[0].attention_bhsd_ref))


def moe_bf16_probs():
    """The bf16-probability control in K4's place, by rows."""
    return sequence_attention(by_rows(attention_bf16_probs))


def routing_flips(a, b, k) -> int:
    """The (token, layer) pairs whose set of top-k experts differs between
    two records of the same calls."""
    flips = 0
    for (_, ids_a, _), (_, ids_b, _) in zip(a, b, strict=True):
        sa = ids_a.reshape(-1, k).sort(dim=-1).values
        sb = ids_b.reshape(-1, k).sort(dim=-1).values
        flips += int((sa != sb).any(dim=-1).sum())
    return flips


def dropped(record) -> list[int]:
    return [int(n) for _, _, n in record]


@contextlib.contextmanager
def pinned_routing(ids_of):
    """Each MoE layer's experts as ``ids_of(call, tokens)`` gives them (a
    recorded run's, call by call), imposed through ``moe._route``'s
    ``ids``: the gates from the layer's own probabilities at those
    experts, the ranks and keep mask recomputed from them, so that two
    arithmetics compare without the discontinuity of routing between
    them."""
    from repro_torch.models import moe

    inner = moe._route
    calls = itertools.count()

    def route(x2d, router, cfg, capacity, ids=None):
        return inner(x2d, router, cfg, capacity,
                     ids=ids_of(next(calls), x2d.shape[0]))

    with swapped(moe, "_route", route):
        yield


def moe_logits_check(bundle, params, batches, kernels, band=None):
    """Each batch's last-position prefill logits through K4 against the
    same model through the plain attention, each run routing as it will:
    logged with the (token, layer) pairs whose top-k experts differ (a
    near-tie in a router's probabilities flips an expert on the last bit
    of the attention) and the pairs dropped at capacity. Without a
    ``band`` (the bfloat16 served depth, where the seeded one-hot
    attention carries a last-bit difference to O(1) within a few layers,
    routing pinned or not: ``moe_layerwise_check`` holds it block by
    block) that is all. With one, the K4 run is read again with the plain
    run's routing imposed (``pinned_routing``), beside the bf16-probability
    control under the same routing, and it fails when that reading passes
    the band or the control does not."""
    import torch

    cfg = bundle.cfg
    what = (f"{cfg.name} {cfg.param_dtype} ({cfg.num_layers} layers) prefill "
            f"logits")
    keys = ("free_rel_l2", "routing_flips", "dropped_pairs")
    out = {k: [] for k in keys + (("rel_l2", "control_rel_l2") if band
                                  else ())}
    for tokens in batches:
        batch = {"tokens": tokens}
        through, plain_record = [], []
        with moe_routing(through):
            free = bundle.prefill_fn(params, batch)[0]
        with moe_plain(kernels), moe_routing(plain_record):
            plain = bundle.prefill_fn(params, batch)[0]
        if not torch.isfinite(free).all():
            fail(f"non-finite {what}")
        out["free_rel_l2"].append(rel_l2(free, plain))
        out["routing_flips"].append(routing_flips(through, plain_record,
                                                  cfg.top_k))
        out["dropped_pairs"].append(sum(dropped(through)))
        agree = float((free.argmax(-1) == plain.argmax(-1)).float().mean())
        pinned = ""
        if band:
            def plain_ids(call, _):
                return plain_record[call][1]

            with pinned_routing(plain_ids):
                got = bundle.prefill_fn(params, batch)[0]
            with pinned_routing(plain_ids), moe_bf16_probs():
                low = bundle.prefill_fn(params, batch)[0]
            if not torch.isfinite(got).all():
                fail(f"non-finite {what}")
            out["rel_l2"].append(rel_l2(got, plain))
            out["control_rel_l2"].append(rel_l2(low, plain))
            pinned = (f"; with the plain run's routing: relative L2 "
                      f"{out['rel_l2'][-1]:.4g} (band {band:.4g}), the "
                      f"bf16-probability control "
                      f"{out['control_rel_l2'][-1]:.4g}")
        log(f"MoE path: {what} through K4 vs the plain attention, each "
            f"routing as it will: relative L2 {out['free_rel_l2'][-1]:.4g}, "
            f"argmax agreement {agree:.2f}, routing flips "
            f"{out['routing_flips'][-1]} of {tokens.numel() * cfg.num_layers}"
            f" (token, layer) pairs, {out['dropped_pairs'][-1]} (token, "
            f"slot) pairs dropped at capacity" + pinned)
        del through, plain_record
    if band is None:
        return out
    if max(out["rel_l2"]) > band:
        fail(f"{what} through K4 (the plain run's routing) differ from the "
             f"plain attention's by {max(out['rel_l2'])} relative (band "
             f"{band})")
    if min(out["control_rel_l2"]) <= band:
        fail(f"{what}: the band {band} does not tell the bf16-probability "
             f"control ({min(out['control_rel_l2'])}) from the plain "
             "attention")
    return out


def moe_layerwise_check(bundle, params, tokens, kernels, band):
    """Every block of the served model fed the input it gets in the
    prefill through the plain attention, with that run's routing
    (``pinned_routing``), so that no difference carries from one block to
    the next: its contribution (output minus input) through K4 against
    the plain run's, by relative L2, beside the bf16-probability control;
    the block routing as it will (its flips) is logged, and beside it each
    block's output in the whole K4 prefill under the same routing (each
    block fed the K4 run's own input: what carries a difference from one
    block to the next). Fails when a reading passes ``band`` or the
    control does not."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg, dev = bundle.cfg, bundle.device
    plain_record, blocks = [], []
    with moe_plain(kernels), moe_routing(plain_record), \
            recorded_blocks(blocks):
        bundle.prefill_fn(params, {"tokens": tokens})
    chained = []
    with pinned_routing(lambda call, _: plain_record[call][1]), \
            recorded_blocks(chained):
        bundle.prefill_fn(params, {"tokens": tokens})
    positions = default_positions(cfg, *tokens.shape, device=dev)
    out = {k: [] for k in ("rel_l2", "control_rel_l2", "free_rel_l2",
                           "routing_flips")}
    out["chained_rel_l2"] = [rel_l2(yk, yp) for (_, yk), (_, yp)
                             in zip(chained, blocks, strict=True)]
    del chained
    layers = list(tf.layers_in_order(params, cfg))
    for i, ((kind, layer, _), (x, y)) in enumerate(zip(layers, blocks,
                                                       strict=True)):
        want = y.to(torch.float32) - x.to(torch.float32)

        def plain_ids(call, _, i=i):
            return plain_record[i][1]

        def contribution(*contexts):
            with contextlib.ExitStack() as stack:
                for context in contexts:
                    stack.enter_context(context)
                got, _, _ = tf.block_apply_seq(layer, x, positions, cfg, kind)
            return got.to(torch.float32) - x.to(torch.float32)

        free_record = []
        out["rel_l2"].append(rel_l2(contribution(pinned_routing(plain_ids)),
                                    want))
        out["control_rel_l2"].append(rel_l2(contribution(
            pinned_routing(plain_ids), moe_bf16_probs()), want))
        out["free_rel_l2"].append(rel_l2(contribution(
            moe_routing(free_record)), want))
        out["routing_flips"].append(routing_flips(
            free_record, plain_record[i:i + 1], cfg.top_k))
    del blocks, plain_record
    what = (f"{cfg.name} {cfg.param_dtype} ({cfg.num_layers} layers) block by "
            f"block")
    log(f"MoE path: {what}, each block's contribution through K4 vs the "
        f"plain attention with the plain run's routing: relative L2 "
        + ", ".join(f"{r:.3g}" for r in out["rel_l2"])
        + f" (band {band:.4g}); the bf16-probability control "
        + ", ".join(f"{r:.3g}" for r in out["control_rel_l2"])
        + "; routing as it will: " + ", ".join(
            f"{r:.3g} ({n} flips)" for r, n in zip(out["free_rel_l2"],
                                                    out["routing_flips"]))
        + "; each block's output in the whole K4 prefill (the same "
        "routing, chained): " + ", ".join(f"{r:.3g}"
                                          for r in out["chained_rel_l2"]))
    if max(out["rel_l2"]) > band:
        fail(f"{what}: relative L2 {max(out['rel_l2'])} above {band}")
    if min(out["control_rel_l2"]) <= band:
        fail(f"{what}: the band {band} does not tell the bf16-probability "
             f"control ({min(out['control_rel_l2'])}) from the plain "
             "attention")
    return out


def moe_teacher_forced_check(bundle, int8, params, prompts, served, kernels,
                             band):
    """``teacher_forced_check`` for the MoE archs: each decode step's
    logits (after K4's prefill), the served tokens fed back, against the
    forward pass through the plain attention over the prompt and the
    tokens before it. The forward's routing (recorded token by token) is
    imposed on the prefill and every decode step (``pinned_routing``), so
    that a flip does not stand in for the decode's arithmetic; the free
    decode is read beside it. The band must catch the int8 KV cache under
    the same routing. Returns the readings and the pairs dropped (at
    ``bundle``'s capacity, which must drop none)."""
    import torch

    cfg = bundle.cfg
    b, s = prompts.shape
    n = served.shape[1]
    layers, k = cfg.num_layers, cfg.top_k
    record = []
    with moe_plain(kernels), moe_routing(record):
        want = torch.stack([
            bundle.forward_fn(params, {"tokens": torch.cat(
                [prompts[j], served[j, :-1]])[None]})[0, s:].to(torch.float32)
            for j in range(b)])
    drops = sum(dropped(record))
    # per layer, (requests, positions, k): the experts of every token
    table = [torch.stack([record[j * layers + i][1].reshape(-1, k)
                          for j in range(b)]) for i in range(layers)]
    del record

    def forward_ids(call, _):
        # the prefill (call // layers == 0), then one decode step a chunk
        i, chunk = call % layers, call // layers
        rows = table[i][:, :s] if chunk == 0 else table[i][:, s + chunk - 1]
        return rows.reshape(-1)

    def readings(model, pinned=True):
        nonlocal drops
        routed = []
        context = (functools.partial(pinned_routing, forward_ids) if pinned
                   else contextlib.nullcontext)
        with context(), moe_routing(routed):
            decoded = replay_decode(model, params, prompts, served)
        drops += sum(dropped(routed))
        return [rel_l2(decoded[j, i], want[j, i])
                for j in range(b) for i in range(n - 1)]

    sound = readings(bundle)
    free = readings(bundle, pinned=False)
    control = readings(int8)
    what = (f"{cfg.name} {cfg.param_dtype} ({cfg.num_layers} layers) "
            f"teacher-forced decode")
    log(f"MoE path: {what} ({b} requests x {n - 1} steps, cache length "
        f"{s + 1}..{s + n - 1}, capacity factor {cfg.capacity_factor}) vs "
        f"the forward pass, with its routing: relative L2 median "
        f"{statistics.median(sound):.4g}, max {max(sound):.4g} (band "
        f"{band:.4g}); the int8 KV cache min {min(control):.4g}, max "
        f"{max(control):.4g}; routing as it will: median "
        f"{statistics.median(free):.4g}, max {max(free):.4g}; {drops} pairs "
        f"dropped in all")
    if max(sound) > band:
        fail(f"{what} logits differ from the forward pass's by {max(sound)} "
             f"relative (band {band})")
    if max(control) <= band:
        fail(f"{what}: the band {band} does not catch the int8 KV cache (at "
             f"most {max(control)})")
    if drops:
        fail(f"{what}: {drops} pairs dropped at capacity factor "
             f"{cfg.capacity_factor}")
    return {"rel_l2_max": max(sound), "rel_l2_median":
            statistics.median(sound), "free_rel_l2_max": max(free),
            "control_rel_l2": [min(control), max(control)],
            "dropped_pairs": drops}


def moe_time_split(bundle, params, tokens, rounds=3):
    """One prefill's MoE layers timed stage by stage: CUDA events recorded
    around ``models/moe.py``'s own calls inside each ``moe_apply`` of the
    prefill (median of ``rounds`` prefills): router and top-k
    (``_route``), dispatch, the expert products, combine, the aux losses,
    arctic's dense residual, and the rest of ``moe_apply`` (the
    destinations and gate weights between the stages). Returns {stage: ms
    summed over the layers}."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = bundle.cfg
    stages = {"_route": "router and top-k", "_dispatch": "dispatch",
              "_experts": "expert products", "_combine": "combine",
              "_aux_losses": "aux losses"}
    if cfg.moe_dense_residual:
        stages["mlp_apply"] = "dense residual"
    spans = []

    def timed(name, fn):
        def run(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((name, start, end))
            return out
        return run

    totals = []
    with contextlib.ExitStack() as stack:
        for attr, name in stages.items():
            stack.enter_context(swapped(moe, attr,
                                        timed(name, getattr(moe, attr))))
        stack.enter_context(swapped(tf, "moe_apply",
                                    timed("moe_apply", tf.moe_apply)))
        for _ in range(rounds):
            spans.clear()
            bundle.prefill_fn(params, {"tokens": tokens})
            torch.cuda.synchronize()
            total = collections.Counter()
            for name, start, end in spans:
                total[name] += start.elapsed_time(end)
            total["the rest of moe_apply"] = total.pop("moe_apply") - sum(
                total[n] for n in stages.values())
            totals.append(total)
    if sum(n == "moe_apply" for n, _, _ in spans) != cfg.num_layers:
        fail(f"MoE time split: {cfg.name}'s prefill ran moe_apply "
             f"{sum(n == 'moe_apply' for n, _, _ in spans)} times, not "
             f"{cfg.num_layers}")
    split = {name: statistics.median(t[name] for t in totals)
             for name in totals[0]}
    log(f"MoE path: {cfg.name} one prefill's {cfg.num_layers} MoE layers "
        f"({tokens.shape[0]} x {tokens.shape[1]} tokens), ms by stage "
        "(CUDA events around moe.py's calls): " + json.dumps(
            {n: round(v, 3) for n, v in split.items()}))
    return split


def moe_serving_path(arch, kernels, counters, device=None, configure=None,
                     prompt=MOE_PROMPT):
    """``arch`` at full width and ``MOE_SERVING[arch]["layers"]`` layers
    (bfloat16, seed ``MOE_SEED``) through ``build_model`` and
    ``ServeEngine.serve_queue`` with the serving checks of
    ``serve_and_check`` (K4 2 x layers launches), the pairs dropped at
    capacity in each prefill and decode step, the prefill logits through
    K4 against the plain attention (``moe_logits_check``) and one
    prefill's MoE time by stage; then, drawn directly in float32 at
    ``f32_layers``, the prefill logits again and the teacher-forced decode
    against the forward pass with the capacity raised to ``E / k`` (no
    pair drops on either side), against the int8 KV cache control.
    ``configure`` narrows the config (a rehearsal on the host). Returns
    the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.models import build_model

    spec = MOE_SERVING[arch]
    narrow = configure or (lambda c: c)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"MoE path {arch}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "held on the card before it")
    bundle, params, _, built = build_seeded(
        arch, MOE_SEED, device, lambda c: narrow(dataclasses.replace(
            c, num_layers=spec["layers"])))
    cfg, dev = bundle.cfg, bundle.device
    rng = np.random.default_rng(MOE_SEED)
    reqs = list(rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, prompt))
                .astype(np.int32))
    routing = []
    numbers, prompts, served = serve_and_check(
        bundle, params, reqs, counters,
        observe=lambda: moe_routing(routing))
    sharpness = attention_sharpness(bundle, params, prompts[:1], kernels)
    # each prefill and decode step runs every layer's router once
    per_call = [(routing[i][0], sum(dropped(routing[i:i + cfg.num_layers])))
                for i in range(0, len(routing), cfg.num_layers)]
    prefill_drops = [n for t, n in per_call if t > SERVE_SLOTS]
    decode_drops = [n for t, n in per_call if t <= SERVE_SLOTS]
    del routing
    log(f"MoE path: {cfg.name} (token, slot) pairs dropped at capacity "
        f"factor {cfg.capacity_factor}: each prefill {prefill_drops} of "
        f"{SERVE_SLOTS * prompt * cfg.top_k * cfg.num_layers}, the decode "
        f"steps {decode_drops} of {SERVE_SLOTS * cfg.top_k * cfg.num_layers} "
        "each")
    batches = [torch.as_tensor(np.stack(reqs[i:i + SERVE_SLOTS]), device=dev)
               for i in range(0, SERVE_REQUESTS, SERVE_SLOTS)]
    bf16 = moe_logits_check(bundle, params, batches, kernels)
    blocks = moe_layerwise_check(bundle, params, batches[0], kernels,
                                 spec["block_band"])
    split = moe_time_split(bundle, params, batches[0])
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()

    # float32, drawn at the cut depth
    b32, p32 = spec["f32_prompt"]
    bundle32, params32, _, built32 = build_seeded(
        arch, MOE_SEED, device, lambda c: narrow(dataclasses.replace(
            c, num_layers=spec["f32_layers"], param_dtype="float32",
            compute_dtype="float32")))
    cfg32 = bundle32.cfg
    prompts32, served32 = prompts[:b32, :p32], served[:b32]
    f32 = moe_logits_check(bundle32, params32, [prompts32], kernels,
                           spec["logits_band"])
    roomy = dataclasses.replace(cfg32, capacity_factor=cfg32.num_experts
                                / cfg32.top_k)
    decode = moe_teacher_forced_check(
        build_model(roomy, dev),
        build_model(dataclasses.replace(roomy, kv_cache_dtype="int8"), dev),
        params32, prompts32, served32, kernels, spec["decode_band"])
    del params32, bundle32
    gc.collect()
    torch.cuda.empty_cache()
    return {**numbers, **built, "layers": cfg.num_layers, "prompt": prompt,
            "prefill_dropped_pairs": prefill_drops,
            "decode_dropped_pairs": decode_drops,
            "attention_sharpness": sharpness,
            "prefill_logits_bf16": bf16, "blocks_bf16": blocks,
            "moe_ms_by_stage": split,
            "f32": {**built32, "layers": cfg32.num_layers,
                    "prompt": [b32, p32], "prefill_logits": f32,
                    "decode": decode}}


def moe_ep_check(device=None, cfg=None, shape=MOE_EP_TOKENS):
    """One full-width dbrx MoE layer (float32, seed ``MOE_SEED``) through
    ``EPContext`` over a one-rank ``DeviceMesh`` of shape (1, 1) ("data",
    "model"), NCCL on the card, its parameters as the rules' DTensor
    shards of each layout, in the gather and the all-to-all layout:
    y, lb and z within the reference's 1e-5 of the local path's
    (``tests/test_moe.py:24-32``). ``cfg`` narrows it (a rehearsal)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.compat import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import single_rank_group
    from repro_torch.launch.partitioning import Partitioner, shard_tensor
    from repro_torch.models.layers import init_params
    from repro_torch.models.moe import EPContext, moe_apply, moe_specs

    dev = resolve_device(device)
    cfg = cfg or dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                                     param_dtype="float32",
                                     compute_dtype="float32")
    single_rank_group(device)
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    params = init_params(moe_specs(cfg), gen, torch.float32, dev)
    x = torch.randn((*shape, cfg.d_model), generator=gen, device=dev)
    out = {}
    with torch.no_grad():
        y, aux = moe_apply(params, x, cfg)
        for layout in ("gather", "a2a"):
            c = dataclasses.replace(cfg, moe_layout=layout)
            # each leaf as the rules' shard of its layout (one rank: views)
            specs = moe_specs(c)
            sharded = {n: shard_tensor(t, Partitioner(mesh).sharding(
                t.shape, specs[n].axes)) for n, t in params.items()}
            got, got_aux = moe_apply(sharded, x, c, EPContext(mesh=mesh))
            err = float((got - y).abs().max())
            ok = bool(torch.allclose(got, y, atol=1e-5, rtol=1e-5)) and all(
                abs(float(got_aux[n]) - float(aux[n]))
                <= 1e-5 * (1 + abs(float(aux[n]))) for n in ("lb", "z"))
            out[layout] = {"max_abs_err": err,
                           "lb": [float(got_aux["lb"]), float(aux["lb"])],
                           "z": [float(got_aux["z"]), float(aux["z"])]}
            log(f"MoE expert parallelism: {cfg.name} one layer ({shape[0]} x "
                f"{shape[1]} tokens, float32) through a one-rank "
                f"{dist.get_backend()} mesh (1, 1), {layout} layout, against "
                f"the local path: y max |diff| {err:.3g}, lb (mesh, local) "
                f"{out[layout]['lb']}, z {out[layout]['z']}")
            if not ok:
                fail(f"MoE expert parallelism, {layout} layout: not within "
                     f"1e-5 of the local path ({out[layout]})")
    del params, x, y
    dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


class FixedBatcher:
    """The ``Trainer``'s batcher interface over one batch, every step."""

    def __init__(self, batch):
        from repro_torch.data.pipeline import DataState

        self.batch = batch
        self.state = DataState()

    def iter_from(self, state):
        self.state = dataclasses.replace(state)
        while True:
            self.state.cursor += 1
            yield self.batch


def run_moe_training_path(counters, device=None, cfg=None, batch=None,
                          seq=None, steps=MOE_TRAIN_STEPS):
    """dbrx_132b at full width and 1 layer (or ``cfg``) trained by
    ``Trainer.run`` under ``run_with_restarts`` for ``steps`` steps on one
    fixed batch of the byte-level corpus, bfloat16 moments, remat, no
    checkpoint (the gemma2 path holds those); the kernel counters set to 0
    before the run and read after it: K4 2 and K4b 1 a layer a
    microbatch, every launch on the tensor cores. The loss must fall;
    ``moe_lb`` and ``moe_z`` must be finite. Returns the path's
    numbers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import CorpusSpec, HostBatcher, ShardedCorpus
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, TrainerConfig, run_with_restarts

    cfg = cfg or dataclasses.replace(get_config(MOE_TRAIN_ARCH), num_layers=1)
    batch, seq = batch or MOE_TRAIN_BATCH, seq or TRAIN_SEQ
    bundle = build_model(cfg, device)
    tcfg = TrainConfig(**MOE_TRAIN_CONFIG)
    corpus = ShardedCorpus(CorpusSpec(
        num_shards=2, tokens_per_shard=2 * batch * (seq + 1),
        seed=TRAIN_SEED))
    fixed = HostBatcher([corpus.shard_tokens(i) for i in range(2)],
                        batch_size=batch, seq_len=seq).take(1)[0]
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        trainer = Trainer(
            bundle, tcfg, FixedBatcher(fixed),
            TrainerConfig(ckpt_dir=tmp, ckpt_every=steps, log_every=1),
            log_fn=log)
        trainer._save = lambda state, step: None
        clock = StepClock(trainer.train_step)
        metrics = []

        def step(state, b):
            state, m = clock(state, b)
            metrics.append({k: float(m[k]) for k in ("loss", "moe_lb",
                                                     "moe_z")})
            return state, m

        trainer.train_step = step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in counters.values():
            w.launches = 0
        routed = {n: collections.Counter(w.route_launches)
                  for n, w in counters.items() if hasattr(w, "route_launches")}
        t0 = time.perf_counter()
        final, restarts = run_with_restarts(
            lambda: trainer.run(steps).final_step)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in counters.items()}
        routes = {n: by_route(collections.Counter(counters[n].route_launches)
                              - before) for n, before in routed.items()}
        peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in clock.last.params.parameters())
    step_s, k4b_ms = list(clock.seconds), list(clock.k4b_ms)
    del clock, trainer
    torch.cuda.empty_cache()
    layers = sum(k in ("attn", "local_attn") for k in layer_kinds(cfg))
    mb = tcfg.microbatches
    want = {"flash_attention": 2 * steps * mb * layers,
            "flash_attention_bwd": steps * mb * layers}
    losses = [m["loss"] for m in metrics]
    log(f"MoE training path {cfg.name} ({cfg.num_layers} layer, "
        f"{n_params} parameters): {steps} steps of one fixed {batch} x {seq} "
        f"batch in {mb} microbatch(es), wall {wall:.2f}s; step seconds "
        f"{[round(t, 3) for t in step_s]}; K4b "
        f"{[round(t, 2) for t in k4b_ms]} ms a step; metrics {metrics}; "
        f"launches {launches} (counted {want}), by route {routes}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    if (final, restarts) != (steps, 0) or len(metrics) != steps or not (
            np.isfinite([list(m.values()) for m in metrics]).all()
            and losses[-1] < losses[0]):
        fail(f"MoE training path: final step {final}, {restarts} restarts, "
             f"metrics {metrics} (finite, the loss falling, wanted)")
    if launches != want:
        fail(f"MoE training path: launches {launches}, not {want}")
    for name, r in routes.items():
        wrong = {k: n for k, n in r.items()
                 if DTYPE_ROUTE.get(k.split("/")[0]) != k.split("/")[1]}
        if wrong or sum(r.values()) != launches[name]:
            fail(f"MoE training path: {name} launches by route {r}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
            "steps": steps, "batch": batch, "seq": seq, "microbatches": mb,
            "wall_s": wall, "step_s": step_s, "k4b_ms_per_step": k4b_ms,
            "metrics": metrics, "launches": launches, "routes": routes,
            "peak_gib": peak / 2**30}

# ------------------------------------------------------------------ encoder-decoder


@contextlib.contextmanager
def encoder_causal():
    """The control that runs the encoder's self attention causal (the
    decoder's calls, causal already, are left as they are)."""
    from repro_torch.models import transformer as tf

    inner = tf.block_apply_seq

    def run(*args, **kw):
        if kw.get("causal") is False:
            kw["causal"] = True
        return inner(*args, **kw)

    with swapped(tf, "block_apply_seq", run):
        yield


@contextlib.contextmanager
def memory_zeroed():
    """The control whose encoder hands the decoder a memory of zeros."""
    from repro_torch.models import transformer as tf

    inner = tf.encoder_apply
    with swapped(tf, "encoder_apply",
                 lambda *args, **kw: inner(*args, **kw).zero_()):
        yield


@contextlib.contextmanager
def recorded_memory(record):
    """Append the encoder's output to ``record`` each time it runs."""
    from repro_torch.models import transformer as tf

    inner = tf.encoder_apply

    def run(*args, **kw):
        out = inner(*args, **kw)
        record.append(out)
        return out

    with swapped(tf, "encoder_apply", run):
        yield


def scale_queries(params, factor):
    """Every attention's query projection (the encoder's and the decoder's
    self attention, the cross attention) multiplied by ``factor``."""
    import torch

    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith(("attn.wq", "cross.wq")):
                p.mul_(factor)


def encdec_batches(cfg, gen, spec, dev):
    """The serving traffic: ``spec["requests"]`` prompts of
    ``spec["prompt"]`` tokens (numpy, from the seed) and sources of
    ``spec["source"]`` frame embeddings (float32, drawn on the card), in
    batches of ``spec["batch"]``: [(prompts, src_embeds)]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(ENCDEC_SEED)
    n, b = spec["requests"], spec["batch"]
    prompts = rng.integers(0, cfg.vocab_size, (n, spec["prompt"])).astype(
        np.int32)
    src = torch.randn((n, spec["source"], cfg.d_model), generator=gen,
                      device=dev)
    return [(prompts[i:i + b], src[i:i + b]) for i in range(0, n, b)]


def encdec_blocks_check(bundle, params, tokens, src, kernels, band):
    """Every block of the model (the encoder's, then the decoder's) fed the
    input, and the decoder's the memory, that it gets in the prefill
    through the plain attention, so that no difference carries from one
    block to the next: its contribution (output minus input) through K4
    against the plain run's, by relative L2, beside the bf16-probability
    control and, logged, each block's output in the whole K4 prefill (each
    block fed the K4 run's own input). ``band`` holds the encoder's and the
    decoder's blocks apart ({"encoder": band, "decoder": band}). Fails
    when a reading passes its band or a control does not."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg, dev = bundle.cfg, bundle.device
    batch = {"tokens": tokens, "src_embeds": src}
    record, memory, chained = [], [], []
    with plain_kernels(*kernels), recorded_blocks(record), \
            recorded_memory(memory):
        bundle.prefill_fn(params, batch)
    with recorded_blocks(chained):
        bundle.prefill_fn(params, batch)
    chained = [rel_l2(yk, yp) for (_, yk), (_, yp) in zip(chained, record,
                                                           strict=True)]
    b, s = tokens.shape
    s_enc = src.shape[1]
    enc_pos = torch.arange(s_enc, dtype=torch.int32, device=dev)[None].expand(
        b, s_enc)
    dec_pos = default_positions(cfg, b, s, device=dev)
    layers = ([("encoder", layer) for layer in params["encoder"]["blocks"]]
              + [(kind, layer) for kind, layer, _ in
                 tf.layers_in_order(params, cfg)])
    sound, controls = {"encoder": [], "decoder": []}, {"encoder": [],
                                                       "decoder": []}
    for (where, layer), (x, y) in zip(layers, record, strict=True):
        section = "encoder" if where == "encoder" else "decoder"
        want = y.to(torch.float32) - x.to(torch.float32)

        def contribution(context):
            with context():
                if where == "encoder":
                    got, _, _ = tf.block_apply_seq(layer, x, enc_pos, cfg,
                                                   "attn", causal=False)
                else:
                    got, _, _ = tf.block_apply_seq(layer, x, dec_pos, cfg,
                                                   where, memory=memory[0])
            return got.to(torch.float32) - x.to(torch.float32)

        sound[section].append(rel_l2(contribution(contextlib.nullcontext),
                                     want))
        controls[section].append(rel_l2(contribution(
            lambda: sequence_attention(attention_bf16_probs)), want))
    del record, memory
    what = (f"{cfg.name} {cfg.param_dtype} ({cfg.encoder_layers} + "
            f"{cfg.num_layers} layers) block by block")
    for section in ("encoder", "decoder"):
        log(f"encoder-decoder path: {what}, each {section} block's "
            f"contribution through K4 vs the plain attention: relative L2 "
            + ", ".join(f"{r:.3g}" for r in sound[section])
            + f" (band {band[section]:.4g}); the bf16-probability control "
            + ", ".join(f"{r:.3g}" for r in controls[section]))
        if max(sound[section]) > band[section]:
            fail(f"{what}, {section}: relative L2 {max(sound[section])} "
                 f"above {band[section]}")
        if min(controls[section]) <= band[section]:
            fail(f"{what}, {section}: the band {band[section]} does not "
                 f"tell the bf16-probability control "
                 f"({min(controls[section])}) from the plain attention")
    log(f"encoder-decoder path: {what}, each block's output in the whole K4 "
        "prefill (chained, encoder blocks first): "
        + ", ".join(f"{r:.3g}" for r in chained))
    return {"rel_l2": sound, "control_rel_l2": controls,
            "chained_rel_l2": chained}


def encdec_f32_checks(bundle, params, prompts, src, served, kernels, spec):
    """On a float32 model: the prefill's last-position logits through K4
    against the plain attention, within ``spec["logits_band"]``, which the
    encoder run causal, the memory zeroed and the bf16-probability control
    must miss; and each decode step's logits, the served
    tokens fed back after K4's prefill, against the forward pass through
    the plain attention at the same position, within
    ``spec["decode_band"]``, which the decode with the cross cache zeroed
    at the hand-off must miss."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg = bundle.cfg
    batch = {"tokens": prompts, "src_embeds": src}
    got = bundle.prefill_fn(params, batch)[0]
    with plain_kernels(*kernels):
        plain = bundle.prefill_fn(params, batch)[0]
    if not torch.isfinite(got).all():
        fail(f"non-finite {cfg.name} float32 prefill logits")
    readings = {"sound": rel_l2(got, plain)}
    for name, context in (
            ("encoder run causal", encoder_causal),
            ("memory zeroed", memory_zeroed),
            ("bf16-probability control",
             lambda: sequence_attention(attention_bf16_probs))):
        with context():
            readings[name] = rel_l2(bundle.prefill_fn(params, batch)[0], plain)
    band = spec["logits_band"]
    what = (f"{cfg.name} float32 ({cfg.encoder_layers} + {cfg.num_layers} "
            f"layers)")
    log(f"encoder-decoder path: {what} prefill logits through K4 vs the "
        f"plain attention: relative L2 {readings['sound']:.4g} (band "
        f"{band:.4g}); controls " + json.dumps(
            {n: float(f"{r:.4g}") for n, r in readings.items()
             if n != "sound"}))
    if readings["sound"] > band:
        fail(f"{what} prefill logits: relative L2 {readings['sound']} above "
             f"{band}")
    for name in ("encoder run causal", "memory zeroed",
                 "bf16-probability control"):
        if readings[name] <= band:
            fail(f"{what} prefill logits: the band {band} does not catch the "
                 f"control '{name}' ({readings[name]})")

    b, s = prompts.shape
    n = served.shape[1]
    with plain_kernels(*kernels):
        want = bundle.forward_fn(params, {
            "tokens": torch.cat([prompts, served[:, :-1]], dim=1),
            "src_embeds": src})[:, s:].to(torch.float32)

    def zero_cross(entry):
        for t in entry["cross"].values():
            t.zero_()

    decode = {}
    for name, handoff in (("sound", None), ("cross cache zeroed", zero_cross)):
        _, cache = bundle.prefill_fn(params, batch)
        cache = tf.pad_cache_to(cache, cfg, s + n)
        if handoff is not None:
            for section in cache.values():
                for entries in section.values():
                    for e in (entries if isinstance(entries, list)
                              else [entries]):
                        handoff(e)
        steps = []
        for i in range(n - 1):
            pos = default_positions(cfg, b, 1, offset=s + i,
                                    device=bundle.device)
            logits, cache = bundle.decode_fn(params, served[:, i:i + 1], pos,
                                             cache, s + i + 1)
            steps.append([rel_l2(logits[j, 0], want[j, i]) for j in range(b)])
        decode[name] = [r for step in steps for r in step]
    band = spec["decode_band"]
    log(f"encoder-decoder path: {what} teacher-forced decode ({b} requests x "
        f"{n - 1} steps, cache length {s + 1}..{s + n - 1}, the cross cache "
        f"{src.shape[1]} rows) vs the forward pass: relative L2 median "
        f"{statistics.median(decode['sound']):.4g}, max "
        f"{max(decode['sound']):.4g} (band {band:.4g}); the cross cache "
        f"zeroed at the hand-off: min {min(decode['cross cache zeroed']):.4g}"
        f", max {max(decode['cross cache zeroed']):.4g}")
    if max(decode["sound"]) > band:
        fail(f"{what} teacher-forced decode: relative L2 "
             f"{max(decode['sound'])} above {band}")
    if min(decode["cross cache zeroed"]) <= band:
        fail(f"{what} teacher-forced decode: the band {band} does not catch "
             f"every step of the cross cache zeroed "
             f"({min(decode['cross cache zeroed'])})")
    return {"prefill_logits": readings,
            "decode": {n: [min(r), max(r)] for n, r in decode.items()}}


def run_encdec_serving_path(kernels, counters, device=None, configure=None,
                            spec=ENCDEC_SERVING):
    """Full-width ``seamless_m4t_medium`` (bfloat16, seed ``ENCDEC_SEED``)
    through ``build_model`` and ``ServeEngine.generate(prompts,
    src_embeds)``, two calls of ``spec["batch"]`` requests, every prefill
    and decode step timed; the kernel counters set to 0 before and read
    after: K4 once a layer (encoder, decoder self, cross) a prefill, every
    launch bfloat16 on the tensor cores. Then: tokens in the vocabulary,
    the same tokens again, the first batch's decode replayed picking them,
    the attention's sharpness at the first encoder, decoder-self and
    cross layers, each block held against the plain attention
    (``encdec_blocks_check``) and, drawn in float32 at ``spec["f32"]``'s
    depth, ``encdec_f32_checks``. ``configure`` narrows the config (a
    rehearsal on the host). Returns the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.serve import ServeConfig, ServeEngine

    narrow = configure or (lambda c: c)
    gc.collect()
    torch.cuda.empty_cache()
    bundle, params, gen, built = build_seeded(ENCDEC_ARCH, ENCDEC_SEED,
                                              device, narrow)
    cfg, dev = bundle.cfg, bundle.device
    batches = encdec_batches(cfg, gen, spec, dev)
    calls = {"prefill": [], "decode": []}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            calls[name].append(time.perf_counter() - t)
            return out
        return run

    new = spec["new"]
    engine = ServeEngine(dataclasses.replace(
        bundle, prefill_fn=timed("prefill", bundle.prefill_fn),
        decode_fn=timed("decode", bundle.decode_fn)), params,
        ServeConfig(max_new_tokens=new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    routed = {name: collections.Counter(w.route_launches)
              for name, w in counters.items() if hasattr(w, "route_launches")}
    t0 = time.perf_counter()
    tokens = np.concatenate([engine.generate(p, src) for p, src in batches])
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}
    routes = {name: by_route(collections.Counter(
        counters[name].route_launches) - before)
        for name, before in routed.items()}
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.encoder_layers + 2 * cfg.num_layers
    want = {name: 0 for name in counters}
    want["flash_attention"] = len(batches) * layers
    steps = len(batches) * (new - 1)
    log(f"encoder-decoder path {cfg.name}: {spec['requests']} requests of "
        f"{spec['source']} source frames and {spec['prompt']} prompt tokens "
        f"in {len(batches)} generate calls, {new} new tokens: wall "
        f"{wall:.2f}s, prefill {[round(t, 4) for t in calls['prefill']]}s, "
        f"decode {sum(calls['decode']):.3f}s over {len(calls['decode'])} "
        f"steps ({1e3 * statistics.median(calls['decode']):.2f} ms a step), "
        f"{tokens.size / wall:.1f} new tokens/s, launches {launches}, by "
        f"route {routes}, peak device memory {peak / 2**30:.2f} GiB")
    if launches != want:
        fail(f"{cfg.name}: kernel launches {launches}, not {want}")
    if (len(calls["prefill"]), len(calls["decode"])) != (len(batches), steps):
        fail(f"{len(calls['prefill'])} prefills and {len(calls['decode'])} "
             f"decode steps, not {len(batches)}, {steps}")
    if tokens.shape != (spec["requests"], new) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens of shape {tokens.shape} outside [0, {cfg.vocab_size})")
    again = np.concatenate([engine.generate(p, src) for p, src in batches])
    if not np.array_equal(tokens, again):
        fail(f"{cfg.name}: a second run gave other tokens "
             f"({int((tokens != again).sum())} differ)")
    prompts0, src0 = batches[0]
    prompts0 = torch.as_tensor(prompts0, device=dev)
    served = torch.as_tensor(tokens[:spec["batch"]], device=dev)
    picks = replay_decode(bundle, params, prompts0, served,
                          extra={"src_embeds": src0}).argmax(-1)
    if not torch.equal(picks.to(served.dtype), served[:, 1:]):
        fail(f"{cfg.name}: the replayed decode picked other tokens than the "
             "engine")
    log(f"encoder-decoder path {cfg.name}: a second run gave the same "
        f"{tokens.size} tokens, and the first batch's decode, replayed with "
        f"them, picks them again; first request's: {tokens[0].tolist()}")
    stats = attention_sharpness(bundle, params, prompts0[:1], kernels,
                                extra={"src_embeds": src0[:1]})
    first = {"encoder": stats[0], "decoder self": stats[cfg.encoder_layers],
             "cross": stats[cfg.encoder_layers + 1]}
    log(f"encoder-decoder path {cfg.name}: the first encoder, decoder-self "
        "and cross layers' attention: " + json.dumps(first))
    blocks = encdec_blocks_check(bundle, params, prompts0, src0, kernels,
                                 spec["block_band"])
    del params, bundle, engine
    gc.collect()
    torch.cuda.empty_cache()

    f32 = spec["f32"]
    bundle32, params32, _, built32 = build_seeded(
        ENCDEC_ARCH, ENCDEC_SEED, device, lambda c: narrow(dataclasses.replace(
            c, encoder_layers=f32["encoder_layers"], num_layers=f32["layers"],
            param_dtype="float32", compute_dtype="float32")))
    checks32 = encdec_f32_checks(bundle32, params32, prompts0, src0, served,
                                 kernels, f32)
    del params32, bundle32
    gc.collect()
    torch.cuda.empty_cache()
    # why the float32 check stops there: the same reading one layer deeper
    # on each side, logged only
    enc, dec = f32["deeper"]
    bundle32, params32, _, _ = build_seeded(
        ENCDEC_ARCH, ENCDEC_SEED, device, lambda c: narrow(dataclasses.replace(
            c, encoder_layers=enc, num_layers=dec, param_dtype="float32",
            compute_dtype="float32")))
    batch = {"tokens": prompts0, "src_embeds": src0}
    got = bundle32.prefill_fn(params32, batch)[0]
    with plain_kernels(*kernels):
        deeper = rel_l2(got, bundle32.prefill_fn(params32, batch)[0])
    log(f"encoder-decoder path: {cfg.name} float32 ({enc} + {dec} layers) "
        f"prefill logits through K4 vs the plain attention (logged, not "
        f"held): relative L2 {deeper:.4g}")
    del params32, bundle32, got
    gc.collect()
    torch.cuda.empty_cache()
    return {**built, "arch": cfg.name, "wall_s": wall,
            "prefill_s": calls["prefill"], "decode_s": sum(calls["decode"]),
            "decode_step_ms": 1e3 * statistics.median(calls["decode"]),
            "new_tokens_per_s": tokens.size / wall, "launches": launches,
            "routes": routes, "peak_gib": peak / 2**30,
            "attention_sharpness": first, "blocks_bf16": blocks,
            "f32": {**built32, "encoder_layers": f32["encoder_layers"],
                    "layers": f32["layers"], **checks32,
                    "deeper": {"layers": [enc, dec], "rel_l2": deeper}}}


def encdec_gradient_check(kernels, counters, device=None, configure=None,
                          spec=ENCDEC_GRAD):
    """One float32 step's gradients of seamless at full width and
    ``spec``'s depth, every query projection scaled by
    ``spec["wq_scale"]`` (the attention's sharpness at the first encoder,
    decoder-self and cross layers logged), through the kernels (K4 and
    K4b) against the same step through their plain versions, worst leaf
    by relative L2 within ``spec["band"]``, which K4b with delta zero and
    K4b on bf16-rounded operands must miss (K4b's plain version on
    operands one ulp apart logged beside them); every encoder leaf's
    gradient non-zero and its worst reading logged."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models import build_model

    cfg = dataclasses.replace(
        get_config(ENCDEC_ARCH), encoder_layers=spec["encoder_layers"],
        num_layers=spec["layers"], param_dtype="float32",
        compute_dtype="float32")
    cfg = configure(cfg) if configure else cfg
    bundle = build_model(cfg, device)
    gen = torch.Generator(device=bundle.device).manual_seed(ENCDEC_SEED)
    params = bundle.init(gen, trainable=True)
    scale_queries(params, spec["wq_scale"])
    rng = np.random.default_rng(ENCDEC_SEED)
    toks = rng.integers(0, cfg.vocab_size, (spec["batch"], spec["target"] + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
             "targets": torch.as_tensor(toks[:, 1:], dtype=torch.int32),
             "src_embeds": torch.randn(
                 (spec["batch"], spec["source"], cfg.d_model), generator=gen,
                 device=bundle.device)}
    stats = attention_sharpness(bundle, params, batch["tokens"][:1],
                                kernels,
                                extra={"src_embeds": batch["src_embeds"][:1]})
    first = {"encoder": stats[0], "decoder self": stats[cfg.encoder_layers],
             "cross": stats[cfg.encoder_layers + 1]}
    log(f"gradient check {cfg.name}, wq scaled by {spec['wq_scale']}: the "
        "first encoder, decoder-self and cross layers' attention: "
        + json.dumps(first))
    for w in counters.values():
        w.launches = 0
    loss, got = gradients(bundle, params, batch)
    launches = {n: w.launches for n, w in counters.items()}
    readings = {}
    with plain_training(*kernels):
        plain_loss, want = gradients(bundle, params, batch)
        for fault in ("delta zero", "bf16 operands", "one ulp"):
            with swapped(attn_ops, "flash_attention_bwd_cuda",
                         functools.partial(attention_bwd_faulty,
                                           fault=fault)):
                _, bad = gradients(bundle, params, batch)
            readings[fault] = worst_leaf(bad, want)
            del bad
    rel, leaf = worst_leaf(got, want)
    encoder = {n: g for n, g in got.items() if n.startswith("encoder.")}
    enc_rel, enc_leaf = worst_leaf(encoder, {n: want[n] for n in encoder})
    zero = [n for n, g in encoder.items() if not bool(g.abs().max() > 0)]
    band = spec["band"]
    layers = cfg.encoder_layers + 2 * cfg.num_layers
    counted = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
    log(f"gradient check {cfg.name} at {cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, batch {spec['batch']} x ({spec['source']} "
        f"frames, {spec['target']} tokens), float32: loss {float(loss):.6f} "
        f"(plain {float(plain_loss):.6f}), launches {launches}; worst leaf "
        f"{leaf} relative L2 {rel:.4g} (band {band:.3g}); the encoder's "
        f"worst {enc_leaf} {enc_rel:.4g}, {len(encoder)} leaves, "
        f"{len(zero)} with a zero gradient; controls " + json.dumps(
            {n: [float(f"{r:.4g}"), lf] for n, (r, lf) in readings.items()}))
    if any(launches.get(n) != c for n, c in counted.items()):
        fail(f"gradient check {cfg.name}: launches {launches}, not {counted}")
    if not torch.isfinite(loss) or rel > band:
        fail(f"gradient check {cfg.name}: leaf {leaf} at relative L2 {rel} "
             f"above {band}")
    if zero:
        fail(f"gradient check {cfg.name}: encoder leaves with a zero "
             f"gradient {zero[:5]}")
    for name in ("delta zero", "bf16 operands"):
        r, lf = readings[name]
        if r <= band:
            fail(f"gradient check {cfg.name}: the control 'K4b with {name}' "
                 f"({r} at {lf}) is inside the band {band}")
    del params, got, want, bundle
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "leaf": leaf, "band": band, "launches": launches,
            "encoder_rel_l2": enc_rel, "encoder_leaf": enc_leaf,
            "wq_scale": spec["wq_scale"], "attention_sharpness": first,
            "controls": {n: r for n, (r, _) in readings.items()}}


def run_encdec_training_path(counters, kernels, device=None, cfg=None,
                             spec=ENCDEC_TRAIN, grad_spec=ENCDEC_GRAD,
                             configure=None):
    """seamless_m4t_medium at full width and depth (or ``cfg``), every
    query projection scaled by ``spec["wq_scale"]``, trained through
    ``make_train_step`` for ``spec["steps"]`` steps on one fixed batch
    (tokens and targets of the byte-level corpus, the source drawn from
    the seed), 2 microbatches, remat, bfloat16 moments; the kernel
    counters set to 0 before and read after: K4 2 and K4b 1 a layer
    (encoder, decoder self, cross) a microbatch, every launch on the tensor
    cores. The loss must be finite and fall. Then
    ``encdec_gradient_check``. Returns the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import CorpusSpec, HostBatcher, ShardedCorpus
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import optimizer as opt

    cfg = cfg or get_config(ENCDEC_ARCH)
    b, steps = spec["batch"], spec["steps"]
    bundle = build_model(cfg, device)
    dev = bundle.device
    tcfg = TrainConfig(**ENCDEC_TRAIN_CONFIG)
    gen = torch.Generator(device=dev).manual_seed(ENCDEC_SEED)
    state = init_train_state(bundle, tcfg, gen)
    corpus = ShardedCorpus(CorpusSpec(
        num_shards=2, tokens_per_shard=2 * b * (spec["target"] + 1),
        seed=ENCDEC_SEED))
    fixed = HostBatcher([corpus.shard_tokens(i) for i in range(2)],
                        batch_size=b, seq_len=spec["target"]).take(1)[0]
    batch = {"tokens": fixed.tokens, "targets": fixed.targets}
    batch["src_embeds"] = torch.randn((b, spec["source"], cfg.d_model),
                                      generator=gen, device=dev)
    # why the queries are scaled: the gradient's global norm at the seeded
    # scale and at the scaled one, on the batch's first microbatch
    half = {k: v[:b // tcfg.microbatches] for k, v in batch.items()}
    norms = {}
    for name, factor in (("seeded", 1.0), ("scaled", spec["wq_scale"])):
        scale_queries(state.params, factor)
        _, grads = gradients(bundle, state.params, half)
        norms[name] = float(opt.global_norm(grads))
        del grads
    log(f"encoder-decoder training path: the gradient's global norm at the "
        f"seeded scale {norms['seeded']:.4g}, with every wq scaled by "
        f"{spec['wq_scale']} {norms['scaled']:.4g}")
    clock = StepClock(make_train_step(bundle, tcfg))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in counters.values():
        w.launches = 0
    routed = {n: collections.Counter(w.route_launches)
              for n, w in counters.items() if hasattr(w, "route_launches")}
    metrics = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = clock(state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in counters.items()}
    routes = {n: by_route(collections.Counter(counters[n].route_launches)
                          - before) for n, before in routed.items()}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.parameters())
    step_s, k4b_ms = list(clock.seconds), list(clock.k4b_ms)
    del clock, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    layers = cfg.encoder_layers + 2 * cfg.num_layers
    mb = tcfg.microbatches
    want = {n: 0 for n in counters}
    want.update(flash_attention=2 * steps * mb * layers,
                flash_attention_bwd=steps * mb * layers)
    losses = [m["loss"] for m in metrics]
    tokens = b * spec["target"]
    log(f"encoder-decoder training path {cfg.name} ({cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, {n_params} parameters): {steps} steps of "
        f"one fixed {b} x ({spec['source']} frames, {spec['target']} tokens) "
        f"batch in {mb} microbatches through make_train_step, wall "
        f"{wall:.2f}s; step seconds {[round(t, 3) for t in step_s]} "
        f"({tokens / statistics.median(step_s):.1f} target tokens/s); K4b "
        f"{[round(t, 2) for t in k4b_ms]} ms a step; metrics {metrics}; "
        f"launches {launches} (counted {want}), by route {routes}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    if len(metrics) != steps or not (
            np.isfinite([list(m.values()) for m in metrics]).all()
            and all(b_ < a_ for a_, b_ in zip(losses, losses[1:]))):
        fail(f"encoder-decoder training path: metrics {metrics} (finite, the "
             f"loss falling, wanted)")
    if launches != want:
        fail(f"encoder-decoder training path: launches {launches}, not "
             f"{want}")
    for name, r in routes.items():
        wrong = {k: n for k, n in r.items()
                 if DTYPE_ROUTE.get(k.split("/")[0]) != k.split("/")[1]}
        if wrong or sum(r.values()) != launches[name]:
            fail(f"encoder-decoder training path: {name} launches by route "
                 f"{r}")
    grads = encdec_gradient_check(kernels, counters, device, configure,
                                  grad_spec)
    return {"arch": cfg.name, "layers": [cfg.encoder_layers, cfg.num_layers],
            "params": n_params, "steps": steps, "batch": b,
            "source": spec["source"], "target": spec["target"],
            "microbatches": mb, "wall_s": wall, "step_s": step_s,
            "k4b_ms_per_step": k4b_ms, "metrics": metrics,
            "launches": launches, "routes": routes, "peak_gib": peak / 2**30,
            "grad_norm_at_init": norms, "gradients_f32": grads}


# ------------------------------------------------------------------ main


def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir() or not SCENARIO.exists():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # DTensor's advice on nested reductions, once a redistribution
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    from repro_torch.compat import require_hopper
    from repro_torch.kernels import attention as k4
    from repro_torch.kernels import checksum as k3
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import rglru as k6
    from repro_torch.kernels import ssd as k5
    from repro_torch.kernels import swarm as kernels

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap}")
    require_hopper(dev)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        # the swarm, K4, K5 and K6 sources once more under -Xptxas -v,
        # beside the builds
        reports = [pool.submit(nvcc.ptxas_report, m.kernel.SOURCE,
                               m.kernel.NVCC_FLAGS)
                   for m in (kernels, k4, k5, k6)]
        libs = nvcc.build(*((m.kernel.SOURCE, m.kernel.NVCC_FLAGS)
                            for m in (kernels, k3, k4, k5, k6)))
        swarm_ptxas = check_ptxas("swarm", reports[0].result(),
                                  SWARM_KERNELS)
        k4_ptxas, k4b_ptxas = check_k4_ptxas(reports[1].result(),
                                             k4.kernel.HEAD_DIMS)
        k5_ptxas = check_ptxas("K5", reports[2].result(), K5_KERNELS)
        k6_ptxas = check_ptxas("K6", reports[3].result(), K6_KERNELS)
    log(f"K6's ring takes {k6.kernel.ring_config()['ring_bytes']} bytes of "
        "dynamic shared memory a CTA, which ptxas does not count")
    log(f"build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f}s")

    with phase("K1, K3, K4, K4b, K5, K6"):
        k1 = check_k1(kernels, dev)
        k1["ptxas"] = {n: v for n, v in swarm_ptxas.items() if "K1" in n}
        check_k3(k3, dev)
        k4_record = check_k4(k4, dev)
        k4_record["ptxas"] = k4_ptxas
        k4_record["moe_prefill"] = check_k4_moe_shapes(k4, dev)
        k4_record["seamless_prefill"] = check_k4_seamless_shapes(k4, dev)
        k4_record["training_shape"] = check_k4_training_shape(k4, dev)
        k4b_record = check_k4b(k4, dev)
        k4b_record["ptxas"] = k4b_ptxas
        with phase("K4 and K4b with a query offset"):
            k4_record["offset"], k4b_record["offset"] = check_k4_offset(
                k4, dev)
        k5_record = check_k5(k5, dev)
        k5_record["ptxas"] = k5_ptxas
        k6_record = check_k6(k6, dev)
        k6_record["ptxas"] = k6_ptxas
    with phase("fleet path and K2"):
        launches, by_form, tables, outcome = run_main_path(kernels)
        k2 = check_k2(kernels, dev, tables)
        k2["ptxas"] = swarm_ptxas["K2 persistent"]
    log(f"K2 persistent kernel: {swarm_ptxas['K2 persistent'][0]} registers "
        f"a thread, a grid of {k2['grid']} CTAs of 256 threads")
    k1["launches"] = launches["rarest_argmin"]
    k1["launches_by_form"] = by_form
    k2["launches"] = launches["waterfill"]
    log("fleet path outcome: " + json.dumps(outcome))
    with phase("broadcast path"):
        k3_record, broadcast = run_broadcast_path(k3)
    log("broadcast path outcome: " + json.dumps(broadcast))
    counters = {"flash_attention": k4.flash_attention_cuda,
                "ssd_chunked": k5.ssd_chunked_cuda,
                "rglru_scan": k6.rglru_scan_cuda}
    with phase(f"serving path {SERVE_ARCH} with its checks"):
        serving = run_serving_path((k4, k5, k6), counters)
    log("serving path outcome: " + json.dumps(serving))
    log(f"split-KV decode calls under the mesh: "
        f"{serving['mesh']['split_kv_calls']}")
    log("serving under a one-rank mesh outcome: "
        + json.dumps(serving["mesh"]))
    paths = {SERVE_ARCH: serving["launches"]}
    routes = {SERVE_ARCH: serving["routes"]}
    for arch in STATE_SERVING:
        with phase(f"serving path {arch} with its checks"):
            outcome = run_state_serving_path(arch, (k4, k5, k6), counters)
        log(f"serving path {arch} outcome: " + json.dumps(outcome))
        paths[arch] = outcome["launches"]
        routes[arch] = outcome["routes"]
    torch.cuda.empty_cache()
    train_counters = {
        "flash_attention": k4.flash_attention_cuda,
        "flash_attention_bwd": k4.flash_attention_bwd_cuda}
    with phase(f"training path {TRAIN_ARCH} with its checkpoint"):
        training = run_training_path(train_counters)
    log("training path outcome: " + json.dumps(training))
    log("elastic restore outcome: " + json.dumps(training["elastic"]))
    with phase(f"mesh-aware train step {TRAIN_ARCH}"):
        mesh_training = run_mesh_train_step(train_counters)
    log("mesh-aware train step outcome: " + json.dumps(mesh_training))
    with phase("float32 gradient checks"):
        grads = gradient_checks((k4, k5, k6), {**counters, **train_counters})
    log("gradient checks outcome: " + json.dumps(grads))
    with phase("crash and restart"):
        crash = crash_restart_check()
    log("crash and restart outcome: " + json.dumps(crash))
    with phase("launchers"):
        run_launchers()
    with phase("the walkthroughs"):
        walkthroughs = run_walkthroughs(k4, train_counters)
    log("walkthroughs outcome: " + json.dumps(walkthroughs))
    for arch in MOE_SERVING:
        with phase(f"MoE serving path {arch} with its checks"):
            outcome = moe_serving_path(arch, (k4, k5, k6), counters)
        log(f"MoE serving path {arch} outcome: " + json.dumps(outcome))
        paths[arch] = outcome["launches"]
        routes[arch] = outcome["routes"]
    with phase("MoE expert parallelism on one card"):
        ep = moe_ep_check()
    log("MoE expert parallelism outcome: " + json.dumps(ep))
    with phase(f"MoE training path {MOE_TRAIN_ARCH}"):
        moe_training = run_moe_training_path(train_counters)
    log("MoE training path outcome: " + json.dumps(moe_training))
    with phase(f"encoder-decoder serving path {ENCDEC_ARCH}"):
        encdec = run_encdec_serving_path((k4, k5, k6), counters)
    log("encoder-decoder serving path outcome: " + json.dumps(encdec))
    paths[ENCDEC_ARCH] = encdec["launches"]
    routes[ENCDEC_ARCH] = encdec["routes"]
    with phase(f"encoder-decoder training path {ENCDEC_ARCH}"):
        encdec_training = run_encdec_training_path(
            {**counters, **train_counters}, (k4, k5, k6))
    log("encoder-decoder training path outcome: "
        + json.dumps(encdec_training))
    # the dry-run's processes, all started together after the timed
    # phases (they take the host's cores), none running while 21b times
    dryrun_out = ROOT / "build" / "dryrun"
    card_cell = start_card_cell(dryrun_out)
    dryrun_procs = start_dryrun_cells(dryrun_out)
    with phase(f"production-mesh dry-run {SERVE_ARCH}"):
        dryrun = run_dryrun_cells(dryrun_out, dryrun_procs)
    log("production-mesh dry-run outcome (predictions): "
        + json.dumps(dryrun))
    with phase(f"the dry-run against the card {TRAIN_ARCH}"):
        against = dryrun_against_the_card(train_counters, dryrun_out,
                                          card_cell)
    log("the dry-run against the card outcome: " + json.dumps(against))
    moe_train_path = f"train {MOE_TRAIN_ARCH}"
    encdec_train_path = f"train {ENCDEC_ARCH}"
    # each kernel's launches on the first path that runs it: serving for
    # K4, K5 and K6, training for K4b
    k4_record["launches"] = paths[SERVE_ARCH]["flash_attention"]
    k4b_record["launches"] = training["launches"]["flash_attention_bwd"]
    k5_record["launches"] = paths["mamba2_1_3b"]["ssd_chunked"]
    k6_record["launches"] = paths["recurrentgemma_2b"]["rglru_scan"]
    for record in (k4_record, k5_record, k6_record):
        record["launches_by_path"] = {
            arch: counts[record["name"]] for arch, counts in paths.items()}
    k4_record["launches_by_path"][f"train {TRAIN_ARCH}"] = (
        training["launches"]["flash_attention"])
    k4_record["launches_by_path"][moe_train_path] = (
        moe_training["launches"]["flash_attention"])
    k4_record["launches_by_path"][encdec_train_path] = (
        encdec_training["launches"]["flash_attention"])
    mesh_serve_path = f"{SERVE_ARCH} under a mesh"
    mesh_train_path = f"train {TRAIN_ARCH} under a mesh"
    k4_record["launches_by_path"][mesh_serve_path] = (
        serving["mesh"]["launches"]["flash_attention"])
    k4_record["launches_by_path"][mesh_train_path] = (
        mesh_training["launches"]["flash_attention"])
    walkthrough_paths = {f"examples.{command}": record
                         for command, record in walkthroughs.items()}
    for path, record in walkthrough_paths.items():
        k4_record["launches_by_path"][path] = (
            record["launches"]["flash_attention"])
    dryrun_path = f"train {TRAIN_ARCH} step of the dry-run's cell"
    k4_record["launches_by_path"][dryrun_path] = (
        against["launches"]["flash_attention"])
    k4b_record["launches_by_path"] = {
        f"train {TRAIN_ARCH}": training["launches"]["flash_attention_bwd"],
        moe_train_path: moe_training["launches"]["flash_attention_bwd"],
        encdec_train_path:
            encdec_training["launches"]["flash_attention_bwd"],
        mesh_train_path: mesh_training["launches"]["flash_attention_bwd"],
        dryrun_path: against["launches"]["flash_attention_bwd"],
        **{path: record["launches"]["flash_attention_bwd"]
           for path, record in walkthrough_paths.items()}}
    train_path = f"train {TRAIN_ARCH}"
    for record, wrapper in ((k4_record, k4.flash_attention_cuda),
                            (k5_record, k5.ssd_chunked_cuda)):
        by_path = {arch: (routes[arch][record["name"]], counts[record["name"]])
                   for arch, counts in paths.items()}
        if record is k4_record:
            by_path[train_path] = (training["routes"]["flash_attention"],
                                   training["launches"]["flash_attention"])
            by_path[moe_train_path] = (
                moe_training["routes"]["flash_attention"],
                moe_training["launches"]["flash_attention"])
            by_path[encdec_train_path] = (
                encdec_training["routes"]["flash_attention"],
                encdec_training["launches"]["flash_attention"])
            by_path[mesh_serve_path] = (
                serving["mesh"]["routes"]["flash_attention"],
                serving["mesh"]["launches"]["flash_attention"])
            by_path[mesh_train_path] = (
                mesh_training["routes"]["flash_attention"],
                mesh_training["launches"]["flash_attention"])
            for path, walk in walkthrough_paths.items():
                by_path[path] = (walk["routes"]["flash_attention"],
                                 walk["launches"]["flash_attention"])
        record["routes"] = check_routes(
            "K4" if record is k4_record else "K5", wrapper.route_launches,
            by_path)
    k4b_record["routes"] = check_routes(
        "K4b", k4.flash_attention_bwd_cuda.route_launches,
        {train_path: (training["routes"]["flash_attention_bwd"],
                      training["launches"]["flash_attention_bwd"]),
         moe_train_path: (moe_training["routes"]["flash_attention_bwd"],
                          moe_training["launches"]["flash_attention_bwd"]),
         encdec_train_path: (
             encdec_training["routes"]["flash_attention_bwd"],
             encdec_training["launches"]["flash_attention_bwd"]),
         mesh_train_path: (
             mesh_training["routes"]["flash_attention_bwd"],
             mesh_training["launches"]["flash_attention_bwd"]),
         **{path: (walk["routes"]["flash_attention_bwd"],
                   walk["launches"]["flash_attention_bwd"])
            for path, walk in walkthrough_paths.items()}})
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all (a limit "
        f"of 1,200 s)")
    log(smi)  # again, so that the end of a long log names the card too
    log(json.dumps({"kernels": [k1, k2, k3_record, k4_record, k4b_record,
                                k5_record, k6_record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def run() -> int:
    try:
        return main()
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(run())
