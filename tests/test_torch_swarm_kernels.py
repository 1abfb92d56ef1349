"""The port's swarm kernels (plain PyTorch versions) vs the JAX package.

On the CPU each wrapper of ``repro_torch.kernels.swarm`` takes its plain
version, so these tests hold those versions to the JAX package's own
contracts (``tests/test_kernels_swarm.py``):

- rarest-argmin is *index-exact* against ``batched_rarest`` (the numpy
  engine hot path) and against the Pallas kernel run in interpret mode;
- water-filling is *bit-exact* against the float32 numpy oracle
  ``waterfill_f32_ref`` (both round every multiply and add on its own),
  within ``1e-4`` of the Pallas kernel (XLA:CPU contracts its updates into
  FMAs) and within ``1e-3`` of the float64 ``waterfill_rates``;
- the compacted water-fill (``waterfill_compact_ref``: active-flow lists
  and touched slots only, the CUDA kernel's way through the fixed point)
  is bit-identical to ``waterfill_ref``, rates, rounds and active flows
  per round.

The CUDA kernels themselves are held against these versions on the card
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.fleet import waterfill_rates
from repro.core.piece_selection import batched_rarest
from repro.kernels.swarm import fleet_waterfill as jax_fleet_waterfill
from repro.kernels.swarm import rarest_argmin as jax_rarest_argmin
from repro.kernels.swarm import waterfill_f32_ref
from repro_torch.core.fleet import waterfill_rates as torch_waterfill_rates
from repro_torch.kernels.swarm import (
    FleetDeviceState,
    fleet_waterfill,
    flow_table,
    link_channel,
    rarest_argmin,
    rarest_argmin_cuda,
    select_rows_cuda,
    waterfill,
    waterfill_compact_ref,
    waterfill_cuda,
    waterfill_ref,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_argmin(cand, avail, jitter):
    out = rarest_argmin(
        _t(cand), _t(np.asarray(avail, dtype=np.float32)), _t(jitter)
    )
    assert out.dtype == torch.int32
    return out.numpy().astype(np.int64)


# ------------------------------------------------------------------ rarest-argmin


def _random_selection(rng, k, P, density):
    cand = rng.random((k, P)) < density
    avail = rng.integers(0, 50, P).astype(np.float64)
    jitter = rng.random((k, P), dtype=np.float32)
    return cand, avail, jitter


@pytest.mark.parametrize(
    "k,P,density",
    [
        (1, 1, 1.0),
        (3, 5, 0.6),
        (17, 100, 0.3),
        (128, 256, 0.5),
        (130, 300, 0.1),
        (64, 1000, 0.9),
        (200, 37, 0.4),
    ],
)
def test_rarest_argmin_index_exact(k, P, density):
    rng = np.random.default_rng(100 + k + P)
    cand, avail, jitter = _random_selection(rng, k, P, density)
    got = _port_argmin(cand, avail, jitter)
    np.testing.assert_array_equal(got, batched_rarest(cand, avail, jitter))
    np.testing.assert_array_equal(got, jax_rarest_argmin(cand, avail, jitter))


def test_rarest_argmin_all_masked_rows():
    rng = np.random.default_rng(1)
    cand, avail, jitter = _random_selection(rng, 40, 90, 0.5)
    cand[::3] = False
    got = _port_argmin(cand, avail, jitter)
    assert (got[::3] == -1).all()
    np.testing.assert_array_equal(got, batched_rarest(cand, avail, jitter))
    np.testing.assert_array_equal(got, jax_rarest_argmin(cand, avail, jitter))


def test_rarest_argmin_single_candidate_rows():
    rng = np.random.default_rng(2)
    k, P = 31, 70
    cand = np.zeros((k, P), dtype=bool)
    only = rng.integers(0, P, k)
    cand[np.arange(k), only] = True
    avail = rng.integers(0, 9, P).astype(np.float64)
    jitter = rng.random((k, P), dtype=np.float32)
    np.testing.assert_array_equal(_port_argmin(cand, avail, jitter), only)


@pytest.mark.parametrize("avail_level", [3, (1 << 24) - 2])
def test_rarest_argmin_forced_ties(avail_level):
    # constant availability and quantized jitter force both tie-break
    # stages, also where counts sit just under the float32-exact bound
    rng = np.random.default_rng(3)
    k, P = 64, 520
    cand = rng.random((k, P)) < 0.8
    avail = np.full(P, float(avail_level))
    avail[::7] += 1
    jitter = (rng.integers(0, 4, (k, P)) / 4.0).astype(np.float32)
    got = _port_argmin(cand, avail, jitter)
    np.testing.assert_array_equal(got, batched_rarest(cand, avail, jitter))
    np.testing.assert_array_equal(got, jax_rarest_argmin(cand, avail, jitter))


def test_rarest_argmin_guards_exact_availability_and_empty():
    cand = np.ones((2, 3), dtype=bool)
    jitter = np.zeros((2, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="exact in float32"):
        _port_argmin(cand, np.full(3, float(1 << 24)), jitter)
    assert _port_argmin(np.zeros((0, 3), bool), np.zeros(3),
                        np.zeros((0, 3), np.float32)).size == 0


# ------------------------------------------------------------------ water-filling


def _random_topology(rng, nf, nn, spine=False, inf_caps=False):
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


@pytest.mark.parametrize("nf,nn", [(1, 2), (5, 3), (37, 10), (300, 40)])
@pytest.mark.parametrize("spine", [False, True])
def test_waterfill_bit_exact_vs_f32_oracle(nf, nn, spine):
    rng = np.random.default_rng(nf * 10 + nn + spine)
    src, dst, up, dn, lof, lcap = _random_topology(rng, nf, nn, spine=spine)
    out = fleet_waterfill(src, dst, up, dn, lof, lcap, device="cpu")
    np.testing.assert_array_equal(
        out.astype(np.float32), waterfill_f32_ref(src, dst, up, dn, lof, lcap)
    )


def test_waterfill_bit_exact_with_inf_caps_many_topologies():
    rng = np.random.default_rng(4)
    for trial in range(40):
        nf = int(rng.integers(1, 400))
        nn = int(rng.integers(2, 50))
        src, dst, up, dn, lof, lcap = _random_topology(
            rng, nf, nn, spine=trial % 2 == 1, inf_caps=trial % 3 == 0
        )
        out = fleet_waterfill(src, dst, up, dn, lof, lcap, device="cpu")
        np.testing.assert_array_equal(
            out.astype(np.float32),
            waterfill_f32_ref(src, dst, up, dn, lof, lcap),
        )


def test_waterfill_band_vs_pallas_and_float64():
    for trial in range(10):
        rng = np.random.default_rng(50 + trial)
        spine = trial % 2 == 1
        src, dst, up, dn, lof, lcap = _random_topology(
            rng, 16 * (trial + 1), 3 * (trial + 1), spine=spine
        )
        out = fleet_waterfill(src, dst, up, dn, lof, lcap, device="cpu")
        pallas = jax_fleet_waterfill(src, dst, up, dn, lof, lcap)
        f64 = waterfill_rates(src, dst, up, dn, lof, lcap)
        np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out, f64, rtol=1e-3, atol=1e-3)
        # the port's copy of the float64 path is the reference's, exactly
        np.testing.assert_array_equal(
            torch_waterfill_rates(src, dst, up, dn, lof, lcap), f64
        )


def test_waterfill_padding_rounds_empty_and_zero_cap():
    assert fleet_waterfill(
        np.zeros(0, np.int64), np.zeros(0, np.int64),
        np.ones(2), np.ones(2), device="cpu",
    ).size == 0
    # zero-capacity uplink: all its flows freeze at 0 in the first round
    out = fleet_waterfill(
        np.zeros(4, np.int64), np.arange(1, 5),
        np.array([0.0, 10, 10, 10, 10]), np.full(5, 10.0), device="cpu",
    )
    np.testing.assert_array_equal(out, np.zeros(4))
    # src = dst = -1 padding flows stay frozen at 0 and change nothing else
    rng = np.random.default_rng(5)
    src, dst, up, dn, _, _ = _random_topology(rng, 30, 6)
    _, lnk, lcap = link_channel(30)
    args = [_t(a) for a in (src.astype(np.int32), dst.astype(np.int32),
                            lnk.astype(np.int32), up.astype(np.float32),
                            dn.astype(np.float32), lcap)]
    rate, rounds = waterfill(*args)
    pad = [torch.cat([a, torch.full((5,), -1, dtype=torch.int32)])
           for a in args[:2]]
    prate, prounds = waterfill(
        *pad, torch.cat([args[2], torch.zeros(5, dtype=torch.int32)]),
        *args[3:],
    )
    assert torch.equal(prate[:30], rate) and (prate[30:] == 0).all()
    assert prounds == rounds >= 1


def test_waterfill_reports_active_flows_per_round():
    # what chip_smoke.py holds the kernel's per-round counts to: one count
    # per round, the first all non-padding flows, falling as flows freeze
    rng = np.random.default_rng(6)
    src, dst, up, dn, lof, lcap = _random_topology(rng, 300, 40, spine=True)
    src[-7:] = dst[-7:] = -1
    _, lnk, lcap = link_channel(300, lof, lcap)
    args = [_t(a) for a in (src.astype(np.int32), dst.astype(np.int32),
                            lnk.astype(np.int32), up.astype(np.float32),
                            dn.astype(np.float32), lcap)]
    active = []
    rate, rounds = waterfill_ref(*args, active_counts=active)
    assert len(active) == rounds >= 2
    assert active[0] == 293
    assert all(a > b for a, b in zip(active, active[1:]))
    plain, plain_rounds = waterfill_ref(*args)
    assert torch.equal(rate, plain) and plain_rounds == rounds


def test_cuda_wrappers_refuse_cpu_tensors():
    # a CPU tensor never reaches a kernel: the CUDA wrappers raise, and
    # only the device dispatch in ops.py routes CPU tensors to ref.py
    cand = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rarest_argmin_cuda(cand, torch.zeros(3), torch.zeros((2, 3)))
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        waterfill_cuda(z, z, z, torch.ones(1), torch.ones(1), torch.ones(1))


# ------------------------------------------------------------------ compacted water-fill


def _compact_case(name, rng):
    """A seeded flow table that exercises one part of the exactness
    argument of the compacted water-fill."""
    nf, nn = 400, 60
    src, dst, up, dn, lof, lcap = _random_topology(rng, nf, nn)
    if name == "dummy_slot_only":
        pass  # every flow unlinked: all of them on the one dummy slot
    elif name == "inf_and_zero_caps":
        up[rng.random(nn) < 0.2] = np.inf
        dn[rng.random(nn) < 0.3] = np.inf
        up[rng.random(nn) < 0.1] = 0.0
        dn[rng.random(nn) < 0.1] = 0.0
    elif name == "all_caps_inf":
        up[:] = np.inf
        dn[:] = np.inf  # delta is never finite: one round, rates 0
    elif name == "padding":
        src[::5] = dst[::5] = -1
    elif name == "spine":
        lof = np.where(rng.random(nf) < 0.6, rng.integers(0, 3, nf), -1)
        lcap = rng.uniform(5.0, 60.0, 3)
    elif name == "spine_padding_inf":
        lof = np.where(rng.random(nf) < 0.5, 0, -1)
        lcap = np.array([np.inf])
        src[-9:] = dst[-9:] = -1
        dn[rng.random(nn) < 0.3] = np.inf
    return flow_table(src, dst, up, dn, lof, lcap, device="cpu")


@pytest.mark.parametrize("name", [
    "dummy_slot_only", "inf_and_zero_caps", "all_caps_inf", "padding",
    "spine", "spine_padding_inf",
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compacted_waterfill_bit_identical_to_plain(name, seed):
    args = _compact_case(name, np.random.default_rng(700 + seed))
    act_plain, act_compact = [], []
    plain, r_plain = waterfill_ref(*args, active_counts=act_plain)
    compact, r_compact = waterfill_compact_ref(*args,
                                               active_counts=act_compact)
    assert torch.equal(compact, plain)
    assert (r_compact, act_compact) == (r_plain, act_plain)
    assert r_plain >= 1


# ------------------------------------------------------------------ wrapper guards


def _refuses(fn, match):
    launches = select_rows_cuda.launches
    with pytest.raises(ValueError, match=match):
        fn()
    assert select_rows_cuda.launches == launches


def test_select_rows_cuda_refuses_before_any_build_or_launch(monkeypatch):
    # the checks run before the library is built: a build here would fail
    # on the missing toolkit with a RuntimeError, not these ValueErrors
    from repro_torch.kernels.swarm import kernel

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernel, "_lib", no_build)
    rng = np.random.default_rng(8)
    n, P = 20, 37
    st = FleetDeviceState(rng.random((n, P), dtype=np.float32),
                          rng.random(P) < 0.5, device="cpu")
    assert st.pitch == 48 and st.have.stride() == (48, 1)
    rows = torch.arange(5, dtype=torch.int64)
    other = torch.full((5,), -1, dtype=torch.int64)
    kw = dict(stream="http", mode="swarm_first", fallback=True)
    state = (st.have, st.jitter, st.repl, st.swarm_class)

    _refuses(lambda: select_rows_cuda(*state, rows, other, **kw),
             "CUDA tensors")
    _refuses(lambda: select_rows_cuda(*state, rows.int(), other, **kw),
             "rows has dtype")
    _refuses(lambda: select_rows_cuda(*state, rows, other.int(), **kw),
             "other has dtype")
    _refuses(lambda: select_rows_cuda(
        st.have, st.jitter, st.repl.long(), st.swarm_class, rows, other,
        **kw), "repl has dtype")
    _refuses(lambda: select_rows_cuda(
        st.have.contiguous(), st.jitter, st.repl, st.swarm_class, rows,
        other, **kw), "pitch")
    _refuses(lambda: select_rows_cuda(
        st.have, st.jitter.double(), st.repl, st.swarm_class, rows, other,
        **kw), "jitter has dtype")
    for bad_rows, bad_other in (([0, n], [-1, -1]), ([-1, 0], [-1, -1]),
                                ([0, 1], [P, -1]), ([0, 1], [-2, 0])):
        _refuses(lambda: select_rows_cuda(
            *state, torch.tensor(bad_rows), torch.tensor(bad_other), **kw),
            r"rows must lie in \[0, 20\) and other in \[-1, 37\)")
    _refuses(lambda: select_rows_cuda(
        *state, rows, other, stream="tcp", mode="swarm_first",
        fallback=True), "unknown stream")


@pytest.mark.parametrize("bad_rows,bad_other", [
    ([0, 20], [-1, -1]), ([-1, 0], [-1, -1]), ([0, 1], [37, -1]),
    ([0, 1], [-2, 0]),
])
def test_device_state_checks_index_ranges_on_the_host(monkeypatch, bad_rows,
                                                      bad_other):
    # FleetDeviceState.select checks rows and other on its host arrays and
    # tells the dispatch so: the CUDA wrapper then needs no synchronisation
    # to check them
    from repro_torch.kernels.swarm import ops

    calls = []

    def dispatch(*args, **kw):
        calls.append(kw)
        return torch.full((args[4].numel(),), -1, dtype=torch.int32)

    monkeypatch.setattr(ops, "select_rows", dispatch)
    rng = np.random.default_rng(9)
    n, P = 20, 37
    st = FleetDeviceState(rng.random((n, P), dtype=np.float32),
                          rng.random(P) < 0.5, device="cpu")
    kw = dict(stream="http", mode="swarm_first", fallback=True)
    with pytest.raises(ValueError,
                       match=r"rows must lie in \[0, 20\) and other in "
                             r"\[-1, 37\)"):
        st.select(np.array(bad_rows), np.array(bad_other), **kw)
    assert not calls
    st.select(np.array([0, n - 1]), np.array([-1, P - 1]), **kw)
    assert calls == [dict(kw, ranges_checked=True)]
