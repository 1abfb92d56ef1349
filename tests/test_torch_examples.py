"""The user walkthroughs of ``examples/`` against their ports,
``repro_torch.examples.<name>``, on the CPU.

The six host-only scripts (the time and byte engines of the copied core)
must print what the reference scripts print, line for line: each runs
in-process with the same small arguments, the reference through
``runpy`` with its ``sys.argv``. The three that reach the model stack run
with ``--device cpu`` (the kernels' plain versions): ``quickstart``'s
stages 1 and 2 and stage 3's ingest line equal the lines the same calls
into the JAX package's ``repro.core``/``repro.data`` give, and its
trained checkpoint differs from its initial parameters in every leaf;
``train_lm`` and ``serve_lm`` start from the reference script's own
initial parameters (its ``init(jax.random.key(seed))`` carried over by
``params_from_jax``) and must print its lines: every logged loss to the
four decimals it prints, through a crash and restart, and every served
token. The corpus is uniform random tokens, so the training loss sits
near ``ln(vocab)`` in both packages; the losses the reference logs are
what tells a trainer that updates from one that does not.
"""

import contextlib
import dataclasses
import io
import json
import math
import re
import runpy
import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: a small model's eager CPU step takes about 50
    ms with them and seconds when every worker takes all the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _reference(name: str, argv: list[str]) -> str:
    def run():
        old = sys.argv
        sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
        try:
            runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
        finally:
            sys.argv = old
    return _stdout(run)


def _port(name: str, argv: list[str]):
    module = __import__(f"repro_torch.examples.{name}", fromlist=["main"])
    result = []
    text = _stdout(lambda: result.append(module.main(argv)))
    return text, result[0]


def _with_reference_weights(module, seed: int):
    """``module.build_model`` whose bundle's ``init`` returns the JAX
    package's ``init(jax.random.key(seed))`` of the same config, whatever
    generator it is given (the reference scripts' initial parameters)."""
    import jax
    import numpy as np
    from repro.models import build_model as jax_build_model
    from repro_torch.models import params_from_jax

    inner = module.build_model

    def build(cfg, device=None):
        bundle = inner(cfg, device)
        tree = jax.tree.map(np.asarray,
                            jax_build_model(cfg).init(jax.random.key(seed)))
        return dataclasses.replace(
            bundle, init=lambda generator, trainable=False: params_from_jax(
                tree, bundle.skeleton(trainable)))
    return build


def _without_times(text: str) -> list[str]:
    """The lines of a walkthrough's output, the wall-clock readings cut
    (a step's milliseconds, the serving rate's line, the trainer's
    straggler lines, which a loaded host prints for a slow step)."""
    return [re.sub(r" \d+ms$", "", line) for line in text.splitlines()
            if " tok/s on " not in line
            and not line.startswith("[trainer] straggler step")]


def _small_scenario(tmp_path, name: str) -> str:
    """The committed scenario with a 2 MiB payload (8 MiB committed)."""
    spec = json.loads((ROOT / "benchmarks" / "scenarios"
                       / f"{name}.json").read_text())
    spec["content"]["manifests"][0]["size_bytes"] = 2 << 20
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(spec))
    return str(path)


HOST_ONLY = {
    "dataset_swarm": lambda tmp: ["--downloads", "4", "--size-gb", "0.5"],
    "hybrid_origin": lambda tmp: ["--peers", "4", "--size-gb", "0.1",
                                  "--mode", "http_first"],
    "mirror_fabric": lambda tmp: ["--peers", "4", "--hosts-per-pod", "2",
                                  "--size-gb", "0.05"],
    "tail_hedging": lambda tmp: ["--peers", "4", "--size-gb", "0.05"],
    "adversarial_swarm": lambda tmp: [
        "--scenario", _small_scenario(tmp, "adversarial")],
    "self_healing": lambda tmp: [
        "--scenario", _small_scenario(tmp, "durability")],
}


@pytest.mark.parametrize("name", sorted(HOST_ONLY))
def test_host_only_walkthrough_prints_the_reference_lines(name, tmp_path):
    argv = HOST_ONLY[name](tmp_path)
    want = _reference(name, argv)
    got, _ = _port(name, argv)
    assert want.count("\n") > 3
    assert got == want


def _reference_quickstart_lines() -> list[str]:
    """Stages 1, 2 and stage 3's ingest line of ``examples/quickstart.py``,
    from the same calls into the JAX package's core and data modules."""
    from repro.core import (
        ArrivalSpec, ContentSpec, EventSpec, FabricSpec, ManifestSpec,
        MirrorSpec, OriginPolicy, ScenarioSpec,
    )
    from repro.data import CorpusSpec, ShardedCorpus, loader_from_corpus

    spec = CorpusSpec(num_shards=8, tokens_per_shard=1 << 14,
                      piece_length=1 << 14, vocab_size=512)
    corpus = ShardedCorpus(spec)
    scenario = ScenarioSpec(
        name="quickstart",
        content=ContentSpec(manifests=(
            ManifestSpec("release", size_bytes=int(256e6),
                         piece_length=int(8e6)),
        )),
        fabric=FabricSpec(mirrors=(
            MirrorSpec("mirror-a", up_bps=12e6, weight=2.0),
            MirrorSpec("mirror-b", up_bps=8e6, weight=1.0),
        )),
        arrivals=(ArrivalSpec(kind="flash", n=12, up_bps=25e6,
                              down_bps=50e6),),
        policy=OriginPolicy(swarm_fraction=1.0, origin_up_bps=20e6,
                            selection="least_loaded"),
        events=(EventSpec(kind="mirror_fail", at=30.0, target="mirror-a"),),
        seed=0,
    )
    blob = scenario.to_json()
    out = scenario.build("time").run().outcomes["release"]
    rep = loader_from_corpus(corpus, num_hosts=4, seed=0).ingest(
        "full_replica")
    return [
        "=== 1. publish a dataset (manifest == torrent) ===",
        f"corpus: {spec.total_tokens} tokens in {spec.num_shards} shards, "
        f"{corpus.manifest.num_pieces} pieces, "
        f"infohash {corpus.manifest.info_hash_hex[:16]}…",
        "",
        "=== 2. declare the delivery scenario (one serializable value) ===",
        f"scenario JSON: {len(blob)} bytes; round-trips: "
        f"{ScenarioSpec.from_json(blob) == scenario}",
        f"flash crowd of {out.clients}: {out.completed} completed in "
        f"{out.duration:.0f}s despite mirror-a dying at t=30s; "
        f"origin served {out.origin_uploaded / 256e6:.2f} copies "
        f"(U/D {out.ud_ratio:.1f}x, Eq. 1)",
        "",
        "=== 3. swarm the corpus to 4 hosts, train a small LM ===",
        f"origin uploaded {rep.origin_uploaded/1e6:.1f} MB for "
        f"{rep.total_downloaded/1e6:.1f} MB delivered "
        f"(U/D amplification {rep.ud_ratio:.1f}x)",
    ]


def test_quickstart_on_the_host(tmp_path, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state, load_checkpoint

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got, report = _port("quickstart", ["--device", "cpu"])
    lines = got.splitlines()
    want = _reference_quickstart_lines()
    assert lines[:len(want)] == want
    assert report.final_step == 60 and len(report.losses) == 4
    assert all(abs(x - math.log(512)) < 0.1 for x in report.losses)
    assert "(on cpu)" in got
    assert "=== 4. broadcast the checkpoint through the swarm ===" in lines
    assert lines[-1] == "all four stages OK"
    # the trainer moved every leaf from the parameters it started from
    bundle = build_model(get_config("granite_3_2b").reduce(vocab_size=512),
                         "cpu")
    tcfg = TrainConfig()

    def initial():
        return init_train_state(bundle, tcfg,
                                torch.Generator().manual_seed(tcfg.seed))

    start, trained = initial(), initial()
    load_checkpoint(tmp_path / "repro_torch_quickstart_ckpt",
                    {"params": trained.params, "opt": trained.opt}, step=60)
    moved = {n: float((a - b).abs().max().detach()) for (n, a), (_, b) in zip(
        trained.params.named_parameters(), start.params.named_parameters())}
    assert len(moved) > 10 and min(moved.values()) > 1e-4, moved


def test_train_lm_restarts_once_after_a_crash(tmp_path, monkeypatch):
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    import jax
    import numpy as np
    from repro_torch.examples import train_lm

    argv = ["--preset", "smoke", "--steps", "20", "--inject-crash-at", "10"]
    want = _reference("train_lm", [*argv, "--ckpt-dir", str(tmp_path / "r")])
    monkeypatch.setattr(train_lm, "build_model",
                        _with_reference_weights(train_lm, 0))
    got, summary = _port("train_lm", [*argv, "--device", "cpu",
                                      "--ckpt-dir", str(tmp_path / "p")])
    assert summary["final_step"] == 20 and summary["restarts"] == 1
    assert summary["device"] == "cpu"
    assert "[supervisor] restart #1 after injected crash at step 10" in got
    assert "[trainer] resumed from step 10" in got
    assert got.splitlines()[-1] == "done: step=20 restarts=1"
    # the reference's lines from its own initial parameters: the count,
    # the ingest, each logged loss to four decimals, the restart
    assert _without_times(got) == _without_times(want)
    assert len(set(round(x, 4) for x in summary["losses"])) == 2
    # the reference's count, from its abstract parameter tree
    base = jax_get_config("granite_3_2b")
    cfg = base.reduce(d_model=64, num_heads=4, head_dim=16, d_ff=128,
                      vocab_size=512, num_layers=len(base.block_pattern)
                      + len(base.tail_pattern))
    n = sum(int(np.prod(s.shape))
            for s in jax.tree.leaves(jax_build_model(cfg).abstract()))
    assert summary["params"] == n
    assert got.splitlines()[0] == (f"arch=granite_3_2b preset=smoke "
                                   f"params={n/1e6:.1f}M steps=20")


def test_serve_lm_serves_every_request(monkeypatch):
    from repro_torch.examples import serve_lm

    argv = ["--requests", "3", "--new-tokens", "5"]
    want = _reference("serve_lm", argv)
    monkeypatch.setattr(serve_lm, "build_model",
                        _with_reference_weights(serve_lm, 0))
    got, outs = _port("serve_lm", [*argv, "--device", "cpu"])
    assert len(outs) == 3 and all(len(o) == 5 for o in outs)
    assert got.splitlines()[-1].startswith("3 requests x 5 tokens in ")
    assert "tok/s on cpu, 2 slots)" in got
    # the reference's tokens, served from its own initial parameters
    assert len(_without_times(want)) == 3
    assert _without_times(got) == _without_times(want)
