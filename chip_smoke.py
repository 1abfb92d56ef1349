"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs from the root of a checkout (it reads ``src/repro_torch`` and the
committed scenario files) on a machine with one Hopper card (H100). It
imports nothing of JAX and nothing of the JAX package. Phases:

1. the card's name and power limit (``nvidia-smi``), torch version, and
   compute capability, which must be 9.0;
2. building the swarm kernels from ``src/repro_torch/kernels/swarm/csrc``;
3. K1 (masked rarest-argmin) on the card against its plain PyTorch
   version, index-exact, at the main path's shape and on edge cases;
4. the main path: ``fleet_scaling.json`` as a 1,000,000-peer flash crowd at
   ``dt = 16`` through ``ScenarioSpec.build("fleet").run()`` with
   ``backend="pallas"``, held to the float64 golden of
   ``BENCH_swarm_scaling.json``; the kernels' launch counts are read from
   this run alone;
5. K2 (max-min water-filling) on the card against its plain version,
   bit-exact (rates, rounds and each round's active-flow count), on flow
   tables captured from the main path and on small random topologies
   (also within 1e-3 of the float64 numpy water-fill);
6. one JSON line of per-kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line. Without CUDA, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

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
# H100 SXM data sheet: HBM rate, and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/swarm/csrc/swarm_kernels.cu"


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


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the float32 operations over their peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / F32_OPS_PER_S * 1e3
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
        "source": KERNEL_SOURCE,
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


# ------------------------------------------------------------------ main path


def run_main_path(kernels, n=N_PEERS, dt=DT, golden_row=GOLDEN_ROW,
                  device=None):
    """The flash crowd through the port's scenario entry point (``device``
    None = the CUDA card, as a user calls it)."""
    import numpy as np
    import torch

    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.kernels.swarm import ops

    spec = ScenarioSpec.load(SCENARIO)
    spec = dataclasses.replace(
        spec,
        arrivals=(dataclasses.replace(spec.arrivals[0], n=n),),
        fleet=dataclasses.replace(spec.fleet, dt=dt, jit=False,
                                  backend="pallas"),
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
    log(f"main path: n={res.n} dt={res.dt} ticks={res.ticks} "
        f"t_all={t_all:.0f}s copies={copies:.2f} ud={res.ud_ratio:.1f} "
        f"done={int(done.sum())}/{res.n} wall={wall:.1f}s "
        f"us_per_client_tick={wall * 1e6 / (res.n * res.ticks):.3f}")
    log(f"main path golden ({golden_row}, float64 numpy): {golden}")
    log("main path phase_seconds: " + json.dumps(res.phase_seconds))
    k2_in_run = sum(k2_seconds)
    log(f"main path waterfill phase split: {k2_in_run:.3f}s in the K2 "
        f"dispatch over {len(k2_seconds)} calls, "
        f"{res.phase_seconds['waterfill'] - k2_in_run:.3f}s host table "
        "build, upload and download")
    log(f"main path launches: {json.dumps(launches)}")
    if int(done.sum()) != n:
        fail(f"only {int(done.sum())}/{n} peers completed")
    band = max(5 * dt, 0.03 * g_tall)
    if abs(t_all - g_tall) > band:
        fail(f"t_all={t_all}s is outside {g_tall}s +- {band}s")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched the {name} kernel")
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
        "source": KERNEL_SOURCE,
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
    lib = kernels.kernel.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f}s")

    k1 = check_k1(kernels, dev)
    launches, tables, outcome = run_main_path(kernels)
    k2 = check_k2(kernels, dev, tables)
    k1["launches"] = launches["rarest_argmin"]
    k2["launches"] = launches["waterfill"]
    log("main path outcome: " + json.dumps(outcome))
    log(json.dumps({"kernels": [k1, k2]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
