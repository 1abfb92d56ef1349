"""The port's checkpoints: its own round trips (the counterparts of
``tests/test_checkpoint.py:23,34,43``) and the format shared with the JAX
package, byte for byte.

The port's parameters are the reference's, through ``params_from_jax``, and
its optimizer state is built from the same numpy values, so the two
packages hold the same tree. A checkpoint that either saves must then load
in the other leaf-equal, the two directories must be the same bytes file
by file, and ``checkpoint_metainfo`` must give the same info-hash. The
bfloat16 state (``opt_state_dtype="bfloat16"``) exercises the ``<V2``
leaves that ``np.save`` writes for an ``ml_dtypes`` array, which the port
writes and reads without ``ml_dtypes``. The reduced granite carries the
round trips; the reduced seamless, whose encoder layers the port keeps one
module each (``encoder.blocks.<l>``) and the reference stacks
(``encoder/blocks/...``), is held to the same bytes and to loading in both
packages. The elastic restore (``load_checkpoint(..., shardings=)``, the
counterpart of ``tests/test_checkpoint.py:60``) brings every leaf back as
a DTensor on a one-rank gloo mesh with the rules' placements, and on a
(2, 2) mesh of gloo ranks each rank holds its own shard.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.train import checkpoint as jckpt
from repro.train.optimizer import OptState as JaxOptState
from repro.train.train_step import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.compat import AbstractMesh
from repro_torch.core import LocalSwarm
from repro_torch.launch import make_test_mesh
from repro_torch.launch.partitioning import Partitioner, shard_slices
from repro_torch.models import build_model, params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import init_train_state
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState
from torch_ranks import run_ranks


def _leaves(tree) -> dict:
    """A port tree as the reference's flat ``{path: numpy}``, bf16 as
    float32 (exact)."""
    return {k: (torch.stack(ts) if st else ts[0]).detach().to(
        torch.float32 if ts[0].is_floating_point() else ts[0].dtype).numpy()
            for k, (ts, st) in ckpt.reference_layout(tree).items()}


def _jax_leaves(tree) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        v = np.asarray(v)
        out[key] = v.astype(np.float32) if v.dtype.name == "bfloat16" else v
    return out


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _pair(arch):
    """The reduced ``arch`` in both packages, with the same parameters and
    the same moved bfloat16 optimizer state (step 3)."""
    jcfg = jax_config(arch).reduce()
    jtcfg = JaxTrainConfig(opt_state_dtype="bfloat16")
    jstate = jax_init_train_state(jax_build(jcfg), jtcfg, jax.random.key(0))
    rng = np.random.default_rng(0)

    def moved(x):
        return jnp.asarray(rng.normal(size=x.shape), jnp.bfloat16)

    jopt = JaxOptState(step=jnp.int32(3), mu=jax.tree.map(moved, jstate.params),
                       nu=jax.tree.map(moved, jstate.params), residual=None)
    jtree = {"params": jstate.params, "opt": jopt}

    pb = build_model(get_config(arch).reduce(), "cpu")
    tcfg = TrainConfig(opt_state_dtype="bfloat16")

    def port_tree():
        model = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                pb.skeleton(trainable=True))
        opt = OptState(step=torch.tensor(3, dtype=torch.int32), mu={}, nu={},
                       residual=None)
        for field in ("mu", "nu"):
            src = params_from_jax(
                jax.tree.map(np.asarray, getattr(jopt, field)), pb.skeleton())
            getattr(opt, field).update(
                {n: p.detach().to(torch.bfloat16)
                 for n, p in src.named_parameters()})
        return {"params": model, "opt": opt}

    return jtree, port_tree, pb, tcfg


@pytest.fixture(scope="module")
def pair():
    return _pair("granite_3_2b")


def _fresh(pb, tcfg, seed=7):
    st = init_train_state(pb, tcfg, torch.Generator().manual_seed(seed))
    return {"params": st.params, "opt": st.opt}


def test_save_load_exact(tmp_path, pair):
    """``tests/test_checkpoint.py:23``."""
    _, port_tree, pb, tcfg = pair
    tree = port_tree()
    ckpt.save_checkpoint(tmp_path, 7, tree, extra={"data": {"epoch": 1}})
    assert ckpt.latest_step(tmp_path) == 7
    like = _fresh(pb, tcfg)
    restored, extra = ckpt.load_checkpoint(tmp_path, like)
    assert restored is like and extra["data"]["epoch"] == 1
    _assert_same(_leaves(restored), _leaves(tree))
    assert ckpt.load_manifest(tmp_path, 7)["step"] == 7


def test_shape_mismatch_rejected(tmp_path, pair):
    """``tests/test_checkpoint.py:34``; a dtype that differs raises too,
    since the port restores into the tensors it is given."""
    _, port_tree, _, _ = pair
    tree = port_tree()
    ckpt.save_checkpoint(tmp_path, 1, tree)
    bad = build_model(get_config("granite_3_2b").reduce(d_ff=96), "cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(tmp_path, {"params": bad.skeleton()})
    wide = build_model(get_config("granite_3_2b").reduce(
        param_dtype="bfloat16"), "cpu")
    with pytest.raises(ValueError, match="dtype"):
        ckpt.load_checkpoint(tmp_path, {"params": wide.skeleton()})


def test_swarm_bundle_roundtrip(tmp_path, pair):
    """``tests/test_checkpoint.py:43``: a checkpoint is a torrent:
    serialize, swarm to 3 hosts, restore."""
    _, port_tree, pb, tcfg = pair
    tree = port_tree()
    ckpt.save_checkpoint(tmp_path / "src", 5, tree)
    mi, payload = ckpt.checkpoint_metainfo(tmp_path / "src", 5,
                                           piece_length=1 << 16)
    swarm = LocalSwarm(mi, dict(mi.split_pieces(payload)), ["h0", "h1", "h2"],
                       seed=0)
    swarm.run()
    pieces = swarm.peers["h2"].store
    out = ckpt.restore_from_bundle(mi, pieces, tmp_path / "h2")
    assert out.name == "step_00000005"
    restored, _ = ckpt.load_checkpoint(tmp_path / "h2", _fresh(pb, tcfg),
                                       step=5)
    _assert_same(_leaves(restored), _leaves(tree))
    assert swarm.ud_ratio > 1.0


def _files(directory) -> dict:
    return {f.name: f.read_bytes() for f in sorted(directory.iterdir())}


def test_the_same_tree_saved_by_both_is_the_same_bytes(tmp_path, pair):
    """Every file, the manifest included, and so the bundle's info-hash
    (which also names the directory: the same name under two roots)."""
    jtree, port_tree, _, _ = pair
    extra = {"data": {"epoch": 0, "cursor": 3, "shuffle_seed": 0}, "step": 9}
    jroot, proot = tmp_path / "jax" / "ckpt", tmp_path / "port" / "ckpt"
    jdir = jckpt.save_checkpoint(jroot, 9, jtree, extra=extra)
    pdir = ckpt.save_checkpoint(proot, 9, port_tree(), extra=extra)
    jfiles, pfiles = _files(jdir), _files(pdir)
    assert sorted(jfiles) == sorted(pfiles)
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name
    manifest = ckpt.load_manifest(proot, 9)
    assert manifest["leaves"]["opt/mu/embed/table"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["opt/step"] == {"file": "opt__step.npy",
                                              "shape": [], "dtype": "int32"}
    jmi, jpayload = jckpt.checkpoint_metainfo(jroot, 9)
    pmi, ppayload = ckpt.checkpoint_metainfo(proot, 9)
    assert ppayload == jpayload
    assert pmi.info_hash == jmi.info_hash


def test_a_reference_checkpoint_loads_in_the_port(tmp_path, pair):
    jtree, _, pb, tcfg = pair
    jckpt.save_checkpoint(tmp_path, 4, jtree, extra={"k": 1})
    restored, extra = ckpt.load_checkpoint(tmp_path, _fresh(pb, tcfg))
    assert extra == {"k": 1}
    _assert_same(_leaves(restored), _jax_leaves(jtree))
    assert restored["opt"].mu["embed.table"].dtype == torch.bfloat16


def test_a_port_checkpoint_loads_in_the_reference(tmp_path, pair):
    """Float32 leaves: the reference's ``load_checkpoint`` hands each
    ``np.load`` to ``jnp.asarray``, which refuses the ``<V2`` words of a
    bfloat16 leaf, its own included (``ROADMAP.md`` §3: a limit of the
    reference), so the bfloat16 moments stay out of this direction."""
    jtree, port_tree, _, _ = pair
    tree = {"params": port_tree()["params"]}
    ckpt.save_checkpoint(tmp_path, 6, tree)
    like = {"params": jax.tree.map(jnp.zeros_like, jtree["params"])}
    restored, _ = jckpt.load_checkpoint(tmp_path, like)
    _assert_same(_jax_leaves(restored), _leaves(tree))
    jckpt.save_checkpoint(tmp_path / "bf16", 1, {"mu": jtree["opt"].mu})
    with pytest.raises(TypeError, match="V2"):
        jckpt.load_checkpoint(tmp_path / "bf16", {"mu": jtree["opt"].mu})


def test_a_params_only_restore_reads_no_optimizer_leaf(tmp_path, pair):
    """``{"params": model}`` restores a model from a training checkpoint,
    as ``launch.serve --ckpt-dir`` does; the optimizer's files are not
    read (here: not there)."""
    _, port_tree, pb, _ = pair
    tree = port_tree()
    path = ckpt.save_checkpoint(tmp_path, 2, tree)
    for f in path.glob("opt__*.npy"):
        f.unlink()
    model = pb.init(torch.Generator().manual_seed(3))
    ckpt.load_checkpoint(tmp_path, {"params": model})
    _assert_same(_leaves({"params": model}), _leaves({"params": tree["params"]}))


def test_trainer_state_is_stored_under_the_reference_paths(tmp_path, pair):
    _, _, pb, _ = pair
    tcfg = TrainConfig(grad_compression="int8")
    st = init_train_state(pb, tcfg, torch.Generator().manual_seed(0))
    assert isinstance(st, TrainState)
    ckpt.save_checkpoint(tmp_path, 1, {"params": st.params, "opt": st.opt})
    leaves = ckpt.load_manifest(tmp_path, 1)["leaves"]
    n = pb.cfg.group_count
    assert leaves["params/groups/0/attn/wq"]["shape"][0] == n
    for part in ("mu", "nu", "residual"):
        assert leaves[f"opt/{part}/groups/0/attn/wq"]["shape"][0] == n
    assert [f.name for f in dataclasses.fields(JaxTrainConfig)] == \
        [f.name for f in dataclasses.fields(TrainConfig)]


def test_an_encoder_decoder_checkpoint_is_the_reference_bytes(tmp_path):
    """seamless: the encoder's per-layer modules stacked back into the
    reference's ``encoder/blocks/...`` leaves, the cross blocks into the
    groups', every file the same bytes and the same info-hash; each
    package loads the other's save (float32 parameters into the
    reference, whose loader refuses bfloat16 leaves)."""
    jtree, port_tree, pb, tcfg = _pair("seamless_m4t_medium")
    cfg = pb.cfg
    jroot, proot = tmp_path / "jax" / "ckpt", tmp_path / "port" / "ckpt"
    jdir = jckpt.save_checkpoint(jroot, 3, jtree)
    tree = port_tree()
    pdir = ckpt.save_checkpoint(proot, 3, tree)
    jfiles, pfiles = _files(jdir), _files(pdir)
    assert sorted(jfiles) == sorted(pfiles)
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name
    leaves = ckpt.load_manifest(proot, 3)["leaves"]
    d, h = cfg.resolved_head_dim, cfg.num_heads
    assert leaves["params/encoder/blocks/attn/wq"]["shape"] == [
        cfg.encoder_layers, cfg.d_model, h, d]
    assert leaves["opt/mu/encoder/blocks/ffn/w_up"]["dtype"] == "bfloat16"
    assert leaves["params/groups/0/cross/wo"]["shape"] == [
        cfg.group_count, h, d, cfg.d_model]
    assert ckpt.checkpoint_metainfo(proot, 3)[0].info_hash == \
        jckpt.checkpoint_metainfo(jroot, 3)[0].info_hash

    restored, _ = ckpt.load_checkpoint(jroot, _fresh(pb, tcfg))
    _assert_same(_leaves(restored), _jax_leaves(jtree))
    ckpt.save_checkpoint(tmp_path / "f32", 1, {"params": tree["params"]})
    like = {"params": jax.tree.map(jnp.zeros_like, jtree["params"])}
    back, _ = jckpt.load_checkpoint(tmp_path / "f32", like)
    _assert_same(_jax_leaves(back), _leaves({"params": tree["params"]}))


def test_elastic_reshard_shardings(tmp_path, pair):
    """``tests/test_checkpoint.py:60``: restore under a mesh; each leaf is
    a DTensor on it with the rules' placements, equal to the saved one."""
    _, port_tree, pb, _ = pair
    tree = port_tree()
    ckpt.save_checkpoint(tmp_path, 2, {"params": tree["params"]})
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        part = Partitioner(mesh)
        shardings = {"params": part.tree_shardings(pb.abstract(), pb.axes)}
        restored, _ = ckpt.load_checkpoint(
            tmp_path, {"params": pb.abstract()}, shardings=shardings)
        saved = _leaves({"params": tree["params"]})
        got = {"params/" + k: v for k, v in _flat(restored["params"]).items()}
        assert set(got) == set(saved)
        for k, leaf in got.items():
            assert isinstance(leaf, DTensor) and leaf.device_mesh is mesh, k
            sharding = _flat(shardings["params"])[k.removeprefix("params/")]
            assert tuple(leaf.placements) == sharding.placements, k
            np.testing.assert_array_equal(
                leaf.to_local().to(torch.float32).numpy(), saved[k], err_msg=k)
        first = next(iter(got.values()))
        assert dict(zip(first.device_mesh.mesh_dim_names,
                        first.device_mesh.shape)) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


RANK_RESTORE = r"""
import torch
from repro_torch.configs import get_config
from repro_torch.launch import make_test_mesh
from repro_torch.launch.partitioning import Partitioner
from repro_torch.models import build_model
from repro_torch.models.layers import tree_leaves
from repro_torch.train import checkpoint as ckpt

mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
bundle = build_model(get_config(SPEC["arch"]).reduce(), "cpu")
shardings = Partitioner(mesh).tree_shardings(bundle.abstract(), bundle.axes)
restored, extra = ckpt.load_checkpoint(SPEC["dir"], {"params": bundle.abstract()},
                                       shardings={"params": shardings})
assert extra == {"data": {"epoch": 3}}
out = {}
for k, leaf in tree_leaves(restored["params"]):
    out[k] = leaf.to_local().to(torch.float32).numpy()
    out["coord"] = np.array(mesh.get_coordinate())
np.savez(OUT, **out)
"""


def test_each_rank_restores_its_own_shard(tmp_path, pair):
    """On a (2, 2) ("data", "model") mesh of gloo ranks, each rank's
    restored leaf is its slice of the saved one, by the rules."""
    _, port_tree, pb, _ = pair
    tree = port_tree()
    ckpt.save_checkpoint(tmp_path / "ckpt", 5, {"params": tree["params"]},
                         extra={"data": {"epoch": 3}})
    ranks = run_ranks(tmp_path, 4, RANK_RESTORE, {
        "arch": "granite_3_2b", "dir": str(tmp_path / "ckpt")})
    saved = _leaves({"params": tree["params"]})
    part = Partitioner(AbstractMesh((2, 2), ("data", "model")))
    axes = _flat(pb.axes)
    split = 0
    for got in ranks:
        coord = tuple(got["coord"])
        for k, ax in axes.items():
            want = saved["params/" + k]
            mine = want[shard_slices(want.shape, part.sharding(want.shape, ax),
                                     coord)]
            np.testing.assert_array_equal(got[k], mine, err_msg=k)
            split += got[k].size < want.size
    assert split > 0
