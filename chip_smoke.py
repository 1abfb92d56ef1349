"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Runs from the root of a checkout (it reads ``src/repro_torch`` and the
committed scenario files) on a machine with one Hopper card (H100). It
imports nothing of JAX and nothing of the JAX package. Phases:

1. the card's name and power limit (``nvidia-smi``), torch version, and
   compute capability, which must be 9.0;
2. building the kernels from ``src/repro_torch/kernels/*/csrc``, one
   ``nvcc`` for each source, all started together;
3. K1 (masked rarest-argmin) on the card against its plain PyTorch
   version, index-exact, at the fleet path's shape and on edge cases;
4. K3 (device checksum) on the card against its plain version, exact,
   on every dtype it reads, lengths 1-7, ``n = b``, ragged ``n``,
   ``block=512``, blocks large enough for the reference's uint32 sums to
   wrap, and a misaligned view;
5. K4 (flash-attention forward) on the card against its plain version:
   the reference's five kernel cases, each also through the public
   ``ops.flash_attention``; keys masked past ``skv_valid`` in a full and a
   ragged tile; q scaled by 8 so the scores reach the softcap's bend; all
   in float32 (2e-5) and bfloat16 (one unit in the last place: rtol 2^-7,
   atol 1e-5). Then the serving path's prefill shape (B 4, S 4608, Hq 8,
   Hkv 4, d 256, bfloat16, softcap 50) at window 0 and 4096, to one unit
   and within a relative L2 band that a bf16-probability control must
   fall outside; its time there against its plain version's and, with
   softcap 0, against ``scaled_dot_product_attention``'s;
6. the fleet path: ``fleet_scaling.json`` as a 1,000,000-peer flash crowd
   at ``dt = 16`` through ``ScenarioSpec.build("fleet").run()`` exactly as
   committed apart from ``n`` and ``dt`` (a file naming no backend runs the
   device tick), held to the float64 golden of
   ``BENCH_swarm_scaling.json``; K1's and K2's launch counts are read from
   this run alone;
7. K2 (max-min water-filling) on the card against its plain version,
   bit-exact (rates, rounds and each round's active-flow count), on flow
   tables captured from the fleet path and on small random topologies
   (also within 1e-3 of the float64 numpy water-fill);
8. the checkpoint broadcast path: stage 2 of
   ``python -m repro_torch.examples.checkpoint_broadcast`` on an 8 GiB
   (2**33-byte) bundle made from a seed, through a one-rank NCCL group:
   stripe, all-gather, K3 on the replica, ``verify_replicas``; K3's launch
   count is read from this run alone. The replica must equal the payload,
   its checksum must equal the stripe's and K3's plain version's, and a
   bit flipped above index 2**32 must change it;
9. the serving path: ``build_model`` of the full-width ``gemma2_2b``
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
   cache) outside;
10. one JSON line of per-kernel numbers, then the last line
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line. Without CUDA, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
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
SWARM_SOURCE = "src/repro_torch/kernels/swarm/csrc/swarm_kernels.cu"
CHECKSUM_SOURCE = "src/repro_torch/kernels/checksum/csrc/checksum_kernels.cu"
ATTENTION_SOURCE = (
    "src/repro_torch/kernels/attention/csrc/attention_kernels.cu")
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
LOGITS_BAND_F32 = 5e-5
LOGITS_BAND_BF16 = 8.5e-3
DECODE_BAND_F32 = 4e-5
# the checkpoint bundle: 2**33 bytes, a bf16 checkpoint of ~4.3B parameters
BUNDLE_BYTES = 1 << 33
BUNDLE_SEED = 12
FLIP_AT = (1 << 32) + 12345


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over their peak (float32
    unless ``ops_per_s`` says otherwise)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / ops_per_s * 1e3
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


def check_k1(kernels, dev):
    """K1 vs its plain version on the card; returns the kernel's record."""
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
    worst = 0
    main = None
    for name, cand, avail, jitter in cases:
        c = torch.from_numpy(cand).to(dev)
        a = torch.from_numpy(avail).to(dev)
        j = torch.from_numpy(jitter).to(dev)
        got = kernels.rarest_argmin_cuda(c, a, j)
        want = kernels.rarest_argmin_ref(c, a, j)
        if not torch.equal(got, want):
            fail(f"K1 {name}: {int((got != want).sum())} picks differ "
                 "from the plain version")
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        if name == "main":
            main = (c, a, j)
        log(f"K1 {name} {tuple(cand.shape)}: index-exact")
    c, a, j = main
    k, P = c.shape
    ms = median_ms(lambda: kernels.rarest_argmin_cuda(c, a, j), reps=20)
    plain_ms = median_ms(lambda: kernels.rarest_argmin_ref(c, a, j), reps=5)
    # each input read once, the picks written once; two float32 compares
    # (availability, then jitter) per candidate
    bound_ms, bound_by = bound(k * P * (1 + 4) + 4 * P + 4 * k,
                               2 * int(c.sum()))
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
        "shape": [k, P],
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

    ops.waterfill = timed_waterfill
    kernels.rarest_argmin_cuda.launches = 0
    kernels.waterfill_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        res = compiled.run().primary
    finally:
        ops.waterfill = dispatch
    wall = time.perf_counter() - t0
    launches = {
        "rarest_argmin": kernels.rarest_argmin_cuda.launches,
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
    log(f"fleet path launches: {json.dumps(launches)}")
    if int(done.sum()) != n:
        fail(f"only {int(done.sum())}/{n} peers completed")
    band = max(5 * dt, 0.03 * g_tall)
    if abs(t_all - g_tall) > band:
        fail(f"t_all={t_all}s is outside {g_tall}s +- {band}s")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the fleet path never launched the {name} kernel")
    return launches, tables, {
        "ticks": res.ticks, "t_all": t_all, "copies": copies, "wall_s": wall,
        "phase_seconds": res.phase_seconds, "k2_dispatch_s": k2_in_run,
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
    round's active-flow count must agree exactly. Returns the kernel's
    rates, its active counts and the largest rate difference."""
    import torch

    act_got, act_want = [], []
    got, r_got = kernels.waterfill_cuda(*args, active_counts=act_got)
    want, r_want = kernels.waterfill_ref(*args, active_counts=act_want)
    if not torch.equal(got, want) or (r_got, act_got) != (r_want, act_want):
        diff = float((got - want).abs().max())
        fail(f"K2 {what}: max |diff| {diff}, rounds {r_got} vs {r_want}, "
             f"active per round {act_got} vs {act_want}")
    return got, act_got, float((got - want).abs().max())


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
        got, _, err = k2_compare(
            kernels, args, f"random topology {trial} (nf={nf}, nn={nn})")
        worst = max(worst, err)
        f64 = waterfill_rates(*table)
        np.testing.assert_allclose(got.cpu().numpy(), f64, rtol=1e-3,
                                   atol=1e-3)
    log("K2 random topologies (24, nf<=2000, nn<=200, spine, inf caps): "
        "bit-exact, within 1e-3 of float64")
    for name in ("first", "largest"):
        args = kernels.flow_table(*tables[name], device=dev)
        _, active, err = k2_compare(kernels, args, f"main-path table {name}")
        worst = max(worst, err)
        log(f"K2 main-path table {name} (nf={args[0].numel()}, "
            f"nodes={args[3].numel()}): bit-exact, {len(active)} rounds, "
            f"active flows per round {active}")
    nf, nn, nlp = args[0].numel(), args[3].numel(), args[5].numel()
    ncon = 2 * nn + nlp
    ms = median_ms(lambda: kernels.waterfill_cuda(*args), reps=5)
    plain_ms = median_ms(lambda: kernels.waterfill_ref(*args), reps=3)
    # Each input read once (src/dst/lnk, the capacities), the rates
    # written once. Float32 operations of this table's rounds: per active
    # flow a rate add and three saturation compares, per constraint slot a
    # subtract, a divide, a min, a multiply and an add.
    bound_ms, bound_by = bound(
        nf * (12 + 4) + ncon * 4, sum(4 * a + 5 * ncon for a in active)
    )
    # The round-by-round bound: a round reads every flow's frozen flag
    # (1 B), the indices and rate of its active flows (12 + 4 B) and three
    # 4-byte vectors per constraint slot.
    round_bound_ms = sum(
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
        "round_bound_ms": round_bound_ms,
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


def live_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (q, k) pairs that K4's masks let through (every key valid)."""
    import numpy as np

    q = np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= q >= k
    if window > 0:
        mask &= q - k < window
    return int(mask.sum())


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float32."""
    import torch

    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).norm() / want.norm())


def attention_bf16_probs(q, k, v, *, causal=True, window=0, softcap=0.0,
                         skv_valid=None):
    """The lower-precision control for K4's bands: the plain version with
    its probabilities rounded to bfloat16 before P·V, as a kernel that
    feeds bf16 P to the tensor cores computes. Same contract and layout as
    ``attention_bhsd_ref``."""
    import math

    import torch

    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, sq, d) / math.sqrt(d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(torch.float32))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = (ki < (skv if skv_valid is None else skv_valid)).expand(sq, skv)
    if causal:
        mask = mask & (qi >= ki)
    if window > 0:
        mask = mask & (qi - ki < window)
    p = torch.softmax(s.masked_fill(~mask, -2e38), dim=-1)
    p = p.to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)


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
            # the public (B, S, H, D) entry of the model's attention
            qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
            compare(what + " via ops.flash_attention",
                    k4.flash_attention(qs, ks, vs, **kw),
                    k4.attention_ref(qs, ks, vs, **kw))
        del q, k, v

    # the serving prefill shape, elementwise and in relative L2 against
    # K4_REL_L2, which must tell the bf16-probability control apart
    b, s, hq, hkv, d = 4, SERVE_PROMPT, 8, 4, 256
    for window in (0, 4096):
        q, k, v = qkv(b, s, s, hq, hkv, d, bf16)
        kw = dict(causal=True, window=window, softcap=50.0)
        what = f"prefill shape {(b, s, hq, hkv, d)} bfloat16 window {window}"
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
    pairs = live_pairs(s, s, True, 0)
    # q, k, v read once and the output written once; 4·d operations per
    # live (q, k) pair and query head (q·k and p·v), at the bf16
    # tensor-core rate
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * b * hq * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_OPS_PER_S)
    log(f"K4 at the prefill shape: {ms:.3f} ms (softcap 0: {nocap_ms:.3f} "
        f"ms), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
        f"(softcap 0) {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP, "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved)")
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
        "shape": [b, s, hq, hkv, d],
        "dtype": "bfloat16",
        "softcap": 50.0,
        "gflop": flops / 1e9,
    }


# ------------------------------------------------------------------ serving


def replay_decode(bundle, params, prompts, tokens):
    """The engine's decode of one batch again, fed its own tokens:
    ``prompts`` (B, S) and ``tokens`` (B, n) as served. Returns the decode
    steps' logits (B, n - 1, V) in float32."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import default_positions

    cfg, dev = bundle.cfg, bundle.device
    b, s = prompts.shape
    n = tokens.shape[1]
    _, cache = bundle.prefill_fn(params, {"tokens": prompts})
    cache = tf.pad_cache_to(cache, cfg, s + n)
    steps = []
    for i in range(n - 1):
        pos = default_positions(cfg, b, 1, offset=s + i, device=dev)
        logits, cache = bundle.decode_fn(params, tokens[:, i:i + 1], pos,
                                         cache, s + i + 1)
        steps.append(logits[:, 0].to(torch.float32))
    return torch.stack(steps, dim=1)


def run_serving_path(k4, device=None):
    """Full-width gemma2_2b through ``build_model`` and
    ``ServeEngine.serve_queue`` on ``device`` (None = the CUDA card), with
    its checks; returns the path's numbers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config(SERVE_ARCH)
    total, _ = cfg.param_count()
    bundle = build_model(cfg, device)
    dev = bundle.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    # the config's count leaves out the norm gains, one d_model vector
    # before each block's attention and FFN and one before the head
    if n_params != total + (2 * cfg.num_layers + 1) * cfg.d_model:
        fail(f"{n_params} parameters, the config counts {total} besides "
             "the norm gains")
    log(f"serving path: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} window={cfg.window}, "
        f"{n_params} parameters ({cfg.param_dtype}) from seed {SERVE_SEED} "
        f"in {init_s:.2f}s")

    rng = np.random.default_rng(SERVE_SEED)
    reqs = list(rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
                .astype(np.int32))
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
    k4.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    outs = engine.serve_queue(reqs, slots=SERVE_SLOTS)
    wall = time.perf_counter() - t0
    launches = k4.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    seconds = {name: list(times) for name, times in calls.items()}
    prefills = -(-SERVE_REQUESTS // SERVE_SLOTS)
    steps = prefills * (SERVE_NEW - 1)
    tokens = np.stack(outs)
    log(f"serving path: {SERVE_REQUESTS} requests x {SERVE_PROMPT} prompt "
        f"tokens, {SERVE_SLOTS} slots, {SERVE_NEW} new tokens: wall "
        f"{wall:.2f}s, prefill {sum(seconds['prefill']):.3f}s over "
        f"{len(seconds['prefill'])} calls, decode "
        f"{sum(seconds['decode']):.3f}s over {len(seconds['decode'])} steps, "
        f"{tokens.size / wall:.1f} new tokens/s, K4 launches {launches}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    want = prefills * cfg.num_layers
    if launches != want:
        fail(f"K4 launched {launches} times on the serving path, not "
             f"{prefills} prefills x {cfg.num_layers} layers = {want}")
    if (len(seconds["prefill"]), len(seconds["decode"])) != (prefills, steps):
        fail(f"{len(seconds['prefill'])} prefills and "
             f"{len(seconds['decode'])} decode steps, not {prefills}, {steps}")
    if tokens.shape != (SERVE_REQUESTS, SERVE_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        fail(f"tokens of shape {tokens.shape} outside [0, {cfg.vocab_size})")
    again = np.stack(engine.serve_queue(reqs, slots=SERVE_SLOTS))
    if not np.array_equal(tokens, again):
        fail(f"a second serve_queue gave other tokens "
             f"({int((tokens != again).sum())} differ)")
    log(f"serving path: a second run gave the same {tokens.size} tokens; "
        f"first request's: {tokens[0].tolist()}")

    # The served tokens again: the first batch's decode replayed with them
    # must pick them again.
    prompts = torch.as_tensor(np.stack(reqs[:SERVE_SLOTS]), device=dev)
    served = torch.as_tensor(tokens[:SERVE_SLOTS], device=dev)
    picks = replay_decode(bundle, params, prompts, served).argmax(-1)
    if not torch.equal(picks.to(served.dtype), served[:, 1:]):
        fail("the replayed decode picked other tokens than the engine")
    log("serving path: the first batch's decode, replayed with the served "
        "tokens, picks them again")

    # Logits against plain references, in bfloat16 as served, then in
    # float32 (the same weights cast), where the rounding floor is low
    # enough for a band to tell a lower-precision control apart.
    batches = [torch.as_tensor(np.stack(reqs[i:i + SERVE_SLOTS]), device=dev)
               for i in range(0, SERVE_REQUESTS, SERVE_SLOTS)]
    bf16_logits = prefill_logits_check(bundle, params, batches, k4,
                                       LOGITS_BAND_BF16, separates=False)
    params = params.to(torch.float32)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    bundle32 = build_model(cfg32, dev)
    f32_logits = prefill_logits_check(bundle32, params, batches[:1], k4,
                                      LOGITS_BAND_F32, separates=True)
    decode = teacher_forced_check(
        bundle32, build_model(dataclasses.replace(cfg32, kv_cache_dtype="int8"),
                              dev),
        params, prompts, served, k4)
    return {
        "arch": cfg.name, "params": n_params, "init_s": init_s,
        "wall_s": wall, "prefill_s": seconds["prefill"],
        "decode_s": sum(seconds["decode"]),
        "decode_step_ms": 1e3 * statistics.median(seconds["decode"]),
        "new_tokens_per_s": tokens.size / wall, "k4_launches": launches,
        "peak_gib": peak / 2**30, "prefill_logits_bf16": bf16_logits,
        "prefill_logits_f32": f32_logits, "decode_f32": decode,
    }


def prefill_logits_check(bundle, params, batches, k4, band, separates):
    """Each batch's last-position prefill logits through K4 against the
    same model through the plain attention (sound), beside the
    bf16-probability attention (the lower-precision control). Fails when a
    sound reading passes ``band`` or, where the band ``separates``, when the
    control does not."""
    import torch

    what = f"{bundle.cfg.param_dtype} prefill logits"
    sound, control = [], []
    for batch in batches:
        batch = {"tokens": batch}
        got = bundle.prefill_fn(params, batch)[0]
        with sequence_attention(k4.attention_bhsd_ref):
            plain = bundle.prefill_fn(params, batch)[0]
        with sequence_attention(attention_bf16_probs):
            low = bundle.prefill_fn(params, batch)[0]
        if not torch.isfinite(got).all():
            fail(f"non-finite {what}")
        sound.append(rel_l2(got, plain))
        control.append(rel_l2(low, plain))
        agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
        log(f"serving path: {what} through K4 vs the plain attention: "
            f"relative L2 {sound[-1]:.4g} (band {band:.4g}), argmax "
            f"agreement {agree:.2f}; the bf16-probability control reads "
            f"{control[-1]:.4g}")
    if max(sound) > band:
        fail(f"{what} through K4 differ from the plain attention's by "
             f"{max(sound)} relative (band {band})")
    if separates and min(control) <= band:
        fail(f"{what}: the band {band} does not tell the bf16-probability "
             f"control ({min(control)}) from the plain attention")
    return {"rel_l2": sound, "control_rel_l2": control}


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


def teacher_forced_check(bundle, int8_bundle, params, prompts, served, k4):
    """Each decode step's logits, with the served tokens fed back, against
    the full-sequence forward pass through the plain attention over the
    prompt and the tokens before it, at the same position: cache lengths
    S + 1 .. S + n - 1, past the local layers' window. The band must catch
    (some step outside it) the int8 KV cache, the lower-precision control,
    and each of ``DECODE_FAULTS``."""
    import torch

    b, s = prompts.shape
    n = served.shape[1]
    with sequence_attention(k4.attention_bhsd_ref):
        want = torch.stack([
            bundle.forward_fn(params, {"tokens": torch.cat(
                [prompts[j], served[j, :-1]])[None]})[0, s:].to(torch.float32)
            for j in range(b)])

    def readings(model):
        decoded = replay_decode(model, params, prompts, served)
        return [rel_l2(decoded[j, i], want[j, i])
                for j in range(b) for i in range(n - 1)]

    sound = readings(bundle)
    controls = {"int8 KV cache": readings(int8_bundle)}
    for name, fault in DECODE_FAULTS.items():
        with decode_fault(fault):
            controls[name] = readings(bundle)
    what = f"{bundle.cfg.param_dtype} teacher-forced decode"
    log(f"serving path: {what} ({b} requests x {n - 1} steps, cache length "
        f"{s + 1}..{s + n - 1}) vs the forward pass: relative L2 median "
        f"{statistics.median(sound):.4g}, max {max(sound):.4g} (band "
        f"{DECODE_BAND_F32:.4g}); controls, min and max: " + "; ".join(
            f"{name} {min(r):.4g}, {max(r):.4g}"
            for name, r in controls.items()))
    if max(sound) > DECODE_BAND_F32:
        fail(f"{what} logits differ from the forward pass's by {max(sound)} "
             f"relative (band {DECODE_BAND_F32})")
    for name, r in controls.items():
        if max(r) <= DECODE_BAND_F32:
            fail(f"{what}: the band {DECODE_BAND_F32} does not catch the "
                 f"control '{name}' (at most {max(r)})")
    return {"rel_l2_max": max(sound),
            "controls_rel_l2": {k: [min(r), max(r)]
                                for k, r in controls.items()}}


# ------------------------------------------------------------------ main


def main() -> int:
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
    from repro_torch.compat import require_hopper
    from repro_torch.kernels import attention as k4
    from repro_torch.kernels import checksum as k3
    from repro_torch.kernels import nvcc
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
    libs = nvcc.build(
        (kernels.kernel.SOURCE, kernels.kernel.NVCC_FLAGS),
        (k3.kernel.SOURCE, k3.kernel.NVCC_FLAGS),
        (k4.kernel.SOURCE, k4.kernel.NVCC_FLAGS),
    )
    log(f"build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f}s")

    k1 = check_k1(kernels, dev)
    check_k3(k3, dev)
    k4_record = check_k4(k4, dev)
    launches, tables, outcome = run_main_path(kernels)
    k2 = check_k2(kernels, dev, tables)
    k1["launches"] = launches["rarest_argmin"]
    k2["launches"] = launches["waterfill"]
    log("fleet path outcome: " + json.dumps(outcome))
    k3_record, broadcast = run_broadcast_path(k3)
    log("broadcast path outcome: " + json.dumps(broadcast))
    serving = run_serving_path(k4)
    k4_record["launches"] = serving["k4_launches"]
    log("serving path outcome: " + json.dumps(serving))
    log(json.dumps({"kernels": [k1, k2, k3_record, k4_record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
