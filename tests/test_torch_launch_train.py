"""The port's training launcher and the serving launcher's ``--ckpt-dir``
on the CPU (the counterparts of the reference's launcher tests,
``tests/test_launch_*.py`` lines 18 and 34, and the elastic launcher
after the training launcher, ``tests/test_launch_drivers.py:18-32``).

``launch.serve --ckpt-dir`` restores a checkpoint that the JAX package
saved and must serve the reference engine's greedy tokens for the same
requests, exactly: the weights are the reference's, and greedy decoding at
the reduced size picks the same argmax (``tests/test_torch_serve.py``
holds the engines' tokens equal on shared weights).
"""

import jax
import numpy as np
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import checkpoint as jckpt
from repro_torch.launch import elastic
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train


def test_launch_train(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    launch_train.main([
        "--arch", "granite_3_2b", "--steps", "20", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-dir", ckpt, "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "swarm ingest U/D" in out and "done step=20 restarts=0" in out
    assert (tmp_path / "ckpt" / "step_00000020" / "manifest.json").exists()

    # the checkpoint it wrote serves
    launch_serve.main(["--arch", "granite_3_2b", "--ckpt-dir", ckpt,
                       "--device", "cpu", "--requests", "2",
                       "--prompt-len", "8", "--new-tokens", "3",
                       "--slots", "2"])
    out = capsys.readouterr().out
    assert f"restored from {ckpt}" in out and "tok/s" in out


def test_launch_train_crash_restart(tmp_path, capsys):
    launch_train.main([
        "--arch", "granite_3_2b", "--steps", "20", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-dir", str(tmp_path / "c2"),
        "--crash-at", "12", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "restart #1" in out and "done step=20 restarts=1" in out
    assert "[trainer] resumed from step 10" in out


def test_launch_serve_ckpt_dir_serves_the_reference_tokens(tmp_path, capsys):
    cfg = jax_config("gemma2_2b").reduce()
    bundle = jax_build(cfg)
    params = bundle.init(jax.random.key(3))
    jckpt.save_checkpoint(tmp_path, 5, {"params": params},
                          extra={"note": "reference"})
    argv = ["--arch", "gemma2_2b", "--ckpt-dir", str(tmp_path), "--device",
            "cpu", "--requests", "3", "--prompt-len", "40", "--new-tokens",
            "5", "--slots", "2"]
    outs = launch_serve.main(argv)
    assert f"restored from {tmp_path}" in capsys.readouterr().out
    # the launcher's requests, made as it makes them
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, (40,)).astype(np.int32)
            for _ in range(3)]
    want = JaxServeEngine(bundle, params, JaxServeConfig(
        max_new_tokens=5)).serve_queue(reqs, slots=2)
    assert len(outs) == len(want) == 3
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(w))


def test_launch_train_moe_arch(tmp_path, capsys):
    """dbrx at ``.reduce()``: the MoE layers' router losses join the loss;
    the checkpoint it writes (experts' ``(E, D, F)`` leaves stacked as the
    reference's ``(L, E, D, F)``) serves."""
    ckpt = str(tmp_path / "moe")
    launch_train.main([
        "--arch", "dbrx_132b", "--steps", "6", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-dir", ckpt, "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "done step=6 restarts=0" in out
    launch_serve.main(["--arch", "dbrx_132b", "--ckpt-dir", ckpt,
                       "--device", "cpu", "--requests", "2",
                       "--prompt-len", "8", "--new-tokens", "3",
                       "--slots", "2"])
    assert f"restored from {ckpt}" in capsys.readouterr().out


def test_launch_train_and_elastic(tmp_path, capsys):
    """``tests/test_launch_drivers.py:18``: the elastic launcher reshards
    what the training launcher wrote onto a one-rank mesh and prints the
    data cursor."""
    ckpt = str(tmp_path / "ckpt")
    launch_train.main([
        "--arch", "granite_3_2b", "--steps", "10", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-dir", ckpt, "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "done step=10" in out
    try:
        elastic.main(["--ckpt-dir", ckpt, "--arch", "granite_3_2b",
                      "--device", "cpu"])
    finally:
        dist.destroy_process_group()
    out = capsys.readouterr().out
    assert "resharded" in out and "data cursor" in out
    assert "{'data': 1, 'model': 1}" in out
