"""The port's data substrate, accounting and HTTP baseline vs the JAX
package's, on the CPU.

The cases of ``tests/test_data_pipeline.py``, ``tests/test_streaming_ingest
.py`` and ``tests/test_tracker_accounting.py`` run through both packages:
each case is one function of a package namespace that returns what the
reference's test looks at, and the two packages must return equal values
(exact: the modules are framework-free copies, so every float is computed
the same way). The reference's own claims are then checked on the port's
values.
"""

import dataclasses
import types

import numpy as np
import pytest

import repro.core as jax_core
import repro.core.accounting as jax_accounting
import repro.data as jax_data
import repro_torch.core as torch_core
import repro_torch.core.accounting as torch_accounting
import repro_torch.data as torch_data

JAX = types.SimpleNamespace(core=jax_core, data=jax_data, acc=jax_accounting)
PORT = types.SimpleNamespace(core=torch_core, data=torch_data,
                             acc=torch_accounting)


def _corpus(pkg, shards=6):
    return pkg.data.ShardedCorpus(pkg.data.CorpusSpec(
        num_shards=shards, tokens_per_shard=2048, piece_length=1024))


def _report(rep):
    out = dataclasses.asdict(rep)
    out["ud_ratio"] = rep.ud_ratio
    return out


def _equal(a, b):
    """Deep equality with numpy arrays compared element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _both(case, *args):
    got, want = case(PORT, *args), case(JAX, *args)
    assert _equal(got, want)
    return got


# ------------------------------------------------------------------ data pipeline


def _corpus_determinism(pkg):
    c = _corpus(pkg)
    again = pkg.data.ShardedCorpus(c.spec)
    return (c.manifest.info_hash, again.manifest.info_hash,
            [c.shard_tokens(i) for i in range(6)], again.shard_tokens(3))


def test_corpus_deterministic():
    h, again, tokens, t3 = _both(_corpus_determinism)
    assert h == again and np.array_equal(tokens[3], t3)


def _shardstore(pkg, root):
    c = _corpus(pkg)
    store = pkg.data.ShardStore(root / pkg.data.__name__)
    pieces = c.origin_pieces()
    put = [store.put_piece(c.manifest, i, pieces[i]) for i in (0, 2, 5)]
    fresh = pkg.data.ShardStore(root / pkg.data.__name__)  # rescan
    held = sorted(fresh.bitfield(c.manifest).indices().tolist())
    garbage = store.put_piece(c.manifest, 1, b"garbage" * 100)
    return put, held, garbage


def test_shardstore_resumable(tmp_path):
    put, held, garbage = _both(_shardstore, tmp_path)
    assert put == [True, True, True] and held == [0, 2, 5] and not garbage


def _full_replica(pkg):
    c = _corpus(pkg)
    loader = pkg.data.loader_from_corpus(c, num_hosts=3, seed=0)
    rep = loader.ingest("full_replica")
    tokens = [[loader.host_shard_tokens(h, s) for s in range(6)]
              for h in range(3)]
    return _report(rep), tokens, [c.shard_tokens(s) for s in range(6)], \
        c.manifest.num_pieces


def test_full_replica_ingest():
    rep, tokens, shards, pieces = _both(_full_replica)
    assert all(n == pieces for n in rep["per_host_pieces"].values())
    assert rep["ud_ratio"] >= 1.0
    assert all(np.array_equal(t, shards[s])
               for host in tokens for s, t in enumerate(host))


def _partitioned(pkg):
    c = _corpus(pkg)
    loader = pkg.data.loader_from_corpus(c, num_hosts=3, seed=0)
    rep = loader.ingest("partitioned", epoch=0)
    asn = pkg.data.shard_assignment(6, 3, 0, 0)
    return (_report(rep), asn, loader.host_shard_tokens(1, asn[1][0]),
            c.shard_tokens(asn[1][0]), c.manifest.length)


def test_partitioned_ingest_origin_one_copy():
    rep, asn, got, want, length = _both(_partitioned)
    assert rep["origin_uploaded"] <= length * 1.01
    assert sorted(sum(asn, [])) == list(range(6))
    assert np.array_equal(got, want)


def _resume(pkg):
    loader = pkg.data.loader_from_corpus(_corpus(pkg), num_hosts=2, seed=0)
    loader.ingest("full_replica")
    first = _report(loader.last_report)
    return first, _report(loader.ingest("full_replica"))


def test_ingest_resume_skips_held_pieces():
    first, again = _both(_resume)
    assert first["origin_uploaded"] > 0
    assert again["origin_uploaded"] == 0.0 and again["rounds"] <= 1


def _local_swarm(pkg):
    c = _corpus(pkg)
    sw = pkg.core.LocalSwarm(c.manifest, c.origin_pieces(),
                             [f"h{i}" for i in range(4)], seed=0)
    rounds = sw.run()
    ledgers = {k: (v.uploaded, v.downloaded) for k, v in sw.ledgers().items()}
    return rounds, sw.ud_ratio, ledgers


def test_local_swarm_ud():
    _, ud, ledgers = _both(_local_swarm)
    assert ud > 1.5
    assert sum(u for u, _ in ledgers.values()) \
        == sum(d for _, d in ledgers.values())


def _batches(pkg):
    c = _corpus(pkg)
    shards = [c.shard_tokens(i) for i in range(4)]
    it1 = iter(pkg.data.HostBatcher(shards, batch_size=4, seq_len=64))
    ref = [next(it1) for _ in range(7)]
    it2 = pkg.data.HostBatcher(shards, batch_size=4, seq_len=64).iter_from(
        pkg.data.DataState(epoch=0, cursor=4, shuffle_seed=0))
    resumed = [next(it2) for _ in range(3)]
    b = pkg.data.HostBatcher(shards, batch_size=4, seq_len=64)
    fetched = list(pkg.data.prefetch(iter(ref), depth=2))
    return ([(x.tokens, x.targets) for x in ref],
            [(x.tokens, x.targets) for x in resumed],
            b._epoch_order(0), b._epoch_order(1),
            [(x.tokens, x.targets) for x in fetched],
            pkg.data.global_batch_layout(32, 4))


def test_batcher_exact_resume_and_reshuffle():
    ref, resumed, e0, e1, fetched, layout = _both(_batches)
    for i in range(3):
        assert np.array_equal(resumed[i][0], ref[4 + i][0])
    assert np.array_equal(ref[0][1][:, 0], ref[0][0][:, 1])
    assert not np.array_equal(e0, e1) and sorted(e0) == sorted(e1)
    assert _equal(fetched, ref) and layout == (8, 0)


# ------------------------------------------------------------------ streaming ingest


def _streaming(pkg, shards, hosts, window):
    c = _corpus(pkg, shards)
    loader = pkg.data.loader_from_corpus(c, num_hosts=hosts, seed=0)
    it = loader.ingest_streaming(window=window)
    first = next(it)
    tok0 = loader.host_shard_tokens(0, 0)
    tail_fetched = loader.host_stores[0].bitfield(c.manifest).complete
    seen = [first] + list(it)
    report = _report(loader.last_report)
    again = list(loader.ingest_streaming(window=window))
    tokens = [[loader.host_shard_tokens(h, s) for s in range(shards)]
              for h in range(hosts)]
    return (seen, tok0, tail_fetched, report, again,
            _report(loader.last_report), tokens,
            [c.shard_tokens(s) for s in range(shards)])


@pytest.mark.parametrize("shards,hosts,window", [(6, 3, 2), (8, 2, 1),
                                                 (4, 2, 2)])
def test_streaming_ingest(shards, hosts, window):
    seen, tok0, tail_fetched, rep, again, rep2, tokens, want = _both(
        _streaming, shards, hosts, window)
    assert seen == again == list(range(shards))
    assert np.array_equal(tok0, want[0])
    if window == 1:
        assert not tail_fetched   # shard 0 consumable before the tail
    assert rep["origin_uploaded"] > 0 and rep["ud_ratio"] > 1.0
    assert rep2["origin_uploaded"] == 0.0
    assert all(np.array_equal(t, want[s])
               for host in tokens for s, t in enumerate(host))


# ------------------------------------------------------------------ accounting


def _eq1(pkg):
    return pkg.core.reddit_case_study()


def test_eq1_reddit_ledger():
    cs = _both(_eq1)
    assert cs["ud_ratio"] == pytest.approx(42.067, rel=2e-3)
    assert cs["cost_per_download"] == pytest.approx(4.42, abs=0.01)
    assert cs["http_bill"] == pytest.approx(424.32, rel=1e-3)
    assert cs["at_bill"] == pytest.approx(10.09, abs=0.01)


def _table1(pkg, ud):
    return [dataclasses.asdict(r) | {
        "cost_savings": r.cost_savings, "http_hours": r.http_hours,
        "at_hours": r.at_hours,
    } for r in pkg.core.paper_table1(ud)]


@pytest.mark.parametrize("ud", [None, 10.0])
def test_table1_rows_match_paper(ud):
    ud = jax_core.PAPER_UD_RATIO if ud is None else ud
    rows = {r["name"]: r for r in _both(_table1, ud)}
    if ud == jax_core.PAPER_UD_RATIO:
        gb, tb = torch_accounting.GB, torch_accounting.TB
        assert rows["whale"]["http_upload_bytes"] == pytest.approx(873.0 * gb)
        assert rows["diabetes"]["http_upload_bytes"] \
            == pytest.approx(8.22 * tb)
        assert rows["whale"]["cost_savings"] == pytest.approx(23.36, rel=0.01)
        assert rows["imagenet"]["http_hours"] == pytest.approx(87.39,
                                                               rel=0.01)


def _ud_edges(pkg):
    return [pkg.core.ud_ratio(a, b)
            for a, b in ((0.0, 0.0), (10.0, 0.0), (42.0, 1.0))]


def test_ud_ratio_edge_cases():
    assert _both(_ud_edges) == [0.0, float("inf"), 42.0]


def _tracker(pkg):
    mi = pkg.core.MetaInfo.from_bytes(b"z" * 4096, 1024)
    tr = pkg.core.Tracker()
    tr.register(mi)
    tr.announce(mi, "origin", uploaded=0, downloaded=0, event="started",
                is_origin=True)
    tr.attach_bitfield(mi, "origin", pkg.core.Bitfield.full(4))
    peers = tr.announce(mi, "p1", uploaded=0, downloaded=0, event="started")
    tr.attach_bitfield(mi, "p1", pkg.core.Bitfield.from_indices(4, [0, 2]))
    avail = tr.availability_map(mi).tolist()
    community = tr.availability_map(mi, include_origins=False).tolist()
    tr.announce(mi, "p1", uploaded=100.0, downloaded=4096.0,
                event="completed")
    tr.announce(mi, "origin", uploaded=3996.0, downloaded=0, event="update",
                is_origin=True)
    st = tr.scrape(mi)
    return peers, avail, community, (st.seeders, st.leechers, st.completed,
                                     st.ud_ratio)


def test_tracker_announce_scrape_and_availability():
    peers, avail, community, stats = _both(_tracker)
    assert peers == ["origin"]
    assert avail == [2, 1, 2, 1] and community == [1, 0, 1, 0]
    assert stats == (2, 0, 1, pytest.approx(4096.0 / 3996.0))


def _handouts(pkg):
    mi = pkg.core.MetaInfo.from_sizes_only(int(64e6), int(8e6), name="ref")
    tr = pkg.core.Tracker(rng=np.random.default_rng(123))
    tr.register(mi)
    script = np.random.default_rng(7)
    out = []
    for step in range(200):
        event = "started" if step < 20 or script.random() < 0.4 else "update"
        pid = f"p{step:03d}" if event == "started" \
            else f"p{int(script.integers(20)):03d}"
        out.append(tr.announce(mi, pid, uploaded=0.0, downloaded=0.0,
                               event=event, want_peers=int(
                                   script.integers(1, 9))))
    return out


def test_announce_handouts_identical():
    assert len(_both(_handouts)) == 200


# ------------------------------------------------------------------ HTTP baseline


def _http(pkg):
    mi = pkg.core.MetaInfo.from_sizes_only(int(4e9), int(32e6), name="x")
    res = pkg.core.simulate_http(
        mi, [(f"c{i}", 10.0 * i) for i in range(20)], 50e6, 25e6)
    return (dataclasses.asdict(res), res.mean_completion_time(),
            res.mean_download_speed(4e9),
            pkg.core.analytic_http(4e9, 100, 50e6, 5e5, concurrency=3))


def test_http_baseline_identical():
    res, mean_t, speed, analytic = _both(_http)
    assert len(res["completion_time"]) == 20 and mean_t > 0 and speed > 0
    assert analytic == (100 * 4e9, 4e9 / 5e5)
