"""The port's mesh and partitioner against the JAX package.

- The six rule tests of ``tests/test_partitioning.py`` on the port's
  ``AbstractMesh`` (and its one-rank gloo mesh).
- Every arch of ``ARCH_IDS`` at full width, with no allocation (the
  port's meta tensors, the reference's ``ShapeDtypeStruct`` s): every
  parameter leaf's spec and every cache leaf's spec on the production
  meshes (16, 16) and (2, 16, 16) equals the JAX ``Partitioner``'s. The
  port's cache keeps one entry a layer where the reference stacks a
  repetition's layers on a leading ``layers`` axis, which its rules never
  shard: the port's spec is the reference's without that first ``None``.
- On (2, 2) ("data", "model") and (2, 2, 2) ("pod", "data", "model") gloo
  meshes (one process a rank), the slice that each rank holds after
  ``device_put_tree`` equals the one that JAX's
  ``NamedSharding(...).devices_indices_map(shape)`` gives the device at
  that mesh position, on forced host devices in a process of its own; so
  does ``shard_slices``, which the elastic restore reads by.
- The mesh's own rules: a shape whose product differs from the world
  raises, and so does a production mesh on one rank.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.jax_compat import abstract_mesh as jax_abstract_mesh
from repro.launch.partitioning import Partitioner as JaxPartitioner
from repro.models import build_model as jax_build
from repro_torch.compat import AbstractMesh
from repro_torch.configs import get_config
from repro_torch.launch import make_production_mesh, make_test_mesh
from repro_torch.launch.partitioning import Partitioner, shard_slices
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from torch_ranks import run_jax, run_ranks


@pytest.fixture
def part():
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        yield Partitioner(mesh)
    finally:
        dist.destroy_process_group()


def mesh_16():
    return AbstractMesh((16, 16), ("data", "model"))


# ----------------------------------------------------- tests/test_partitioning.py


def test_fsdp_plus_tp_2d():
    assert Partitioner(mesh_16()).spec((2048, 8192), ("embed", "mlp")) == \
        ("data", "model")


def test_kv_heads_fallback_replicates():
    big = Partitioner(mesh_16())
    assert big.spec((2304, 4, 256), ("embed", "kv_heads", "head")) == \
        ("data", None, None)
    assert big.spec((2304, 32, 64), ("embed", "q_heads", "head")) == \
        ("data", "model", None)


def test_vocab_non_divisible_fallback():
    big = Partitioner(mesh_16())
    assert big.spec((256206, 1024), ("vocab", "embed")) == (None, "data")
    assert big.spec((256000, 1024), ("vocab", "embed")) == ("model", "data")


def test_mesh_axis_used_once_per_array():
    big = Partitioner(mesh_16())
    assert big.spec((128, 4864), ("experts", "mlp")) == ("model", None)


def test_multipod_batch_axes():
    big = Partitioner(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert big.spec((256, 4096), ("batch", None)) == (("pod", "data"), None)
    sharding = big.sharding((256, 4096), ("batch", None))
    assert [str(p) for p in sharding.placements] == ["S(0)", "S(0)", "R"]


def test_scanned_layer_dim_never_sharded(part):
    # on the one-rank mesh every size-1 axis divides: only "layers" stays
    # unsharded
    assert part.spec((13, 2048, 8192), ("layers", "embed", "mlp")) == \
        (None, "data", "model")
    assert Partitioner(mesh_16()).spec(
        (13, 2048, 8192), ("layers", "embed", "mlp"))[0] is None


# ----------------------------------------------------- full width, every arch

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE = dict(batch=32, capacity=8192, cross_len=4096)


def _jax_tree(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple) and all(
                    isinstance(e, (str, type(None))) for e in x))[0]}


def _port_tree(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of nested dicts and lists (list items by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_port_tree(v, f"{prefix}{k}/"))
    return out


def _unstacked(path: str) -> str:
    """The reference's cache path of a port cache leaf: the repetition
    index after ``groups/<i>`` dropped."""
    parts = path.split("/")
    return "/".join(parts[:2] + parts[3:]) if parts[0] == "groups" else path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_spec_matches_the_reference(arch):
    jb = jax_build(jax_config(arch))
    pb = build_model(get_config(arch), "cpu")
    jabs, jaxes = _jax_tree(jb.abstract()), _jax_tree(jb.axes)
    pabs, paxes = _port_tree(pb.abstract()), _port_tree(pb.axes)
    assert set(pabs) == set(jabs) == set(paxes) == set(jaxes)
    assert all(p.device.type == "meta" for p in pabs.values())
    cross = CACHE["cross_len"] if jb.cfg.encoder_layers else 0
    jcache = jax.eval_shape(lambda: jb.cache_init(
        CACHE["batch"], CACHE["capacity"], cross))
    jcache, jcache_axes = _jax_tree(jcache), _jax_tree(jb.cache_axes(
        CACHE["batch"], CACHE["capacity"], cross))
    pcache_axes = _port_tree(pb.cache_axes(
        CACHE["batch"], CACHE["capacity"], cross))
    pcache = _port_tree(tf.cache_init(
        pb.cfg, CACHE["batch"], CACHE["capacity"], torch.bfloat16, "meta",
        cross))
    assert set(pcache) == set(pcache_axes)
    assert {_unstacked(k) for k in pcache} == set(jcache)
    for shape, names in MESHES:
        want = JaxPartitioner(jax_abstract_mesh(shape, names))
        got = Partitioner(AbstractMesh(shape, names))
        for k, leaf in jabs.items():
            assert tuple(pabs[k].shape) == tuple(leaf.shape), k
            assert got.spec(tuple(pabs[k].shape), paxes[k]) == tuple(
                want.spec(leaf.shape, jaxes[k])), (shape, k)
        for k, axes in pcache_axes.items():
            ref = _unstacked(k)
            jspec = tuple(want.spec(jcache[ref].shape, jcache_axes[ref]))
            stacked = k != ref
            if stacked:
                assert jspec[0] is None and jcache_axes[ref][0] == "layers"
                jspec = jspec[1:]
            assert tuple(pcache[k].shape) == tuple(
                jcache[ref].shape[1 if stacked else 0:]), k
            assert got.spec(tuple(pcache[k].shape), axes) == jspec, (shape, k)


# ----------------------------------------------------- each rank's slice

SMALL = {"shape": [2, 2], "names": ["data", "model"]}
POD = {"shape": [2, 2, 2], "names": ["pod", "data", "model"]}
LEAVES = {   # name -> (shape, logical axes)
    "wq": ((64, 4, 16), ("embed", "q_heads", "head")),
    "w_up": ((64, 128), ("embed", "mlp")),
    "table": ((512, 64), ("vocab", "embed")),
    "kv_heads": ((64, 2, 16), ("embed", "kv_heads", "head")),
    "cache_k": ((8, 64, 2, 16), ("batch", "kv_seq", "kv_heads", "head")),
    "tokens": ((8, 12), ("batch", None)),
    "positions": ((3, 8, 12), (None, "batch", None)),
    "experts": ((4, 64, 128), ("experts", "embed", "mlp")),
    "gain": ((64,), ("embed",)),
}

JAX_SLICES = r"""
import jax, numpy as np
from jax.sharding import Mesh
from repro.launch.partitioning import Partitioner
out = {}
for spec in SPEC["meshes"]:
    shape, names = tuple(spec["shape"]), tuple(spec["names"])
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
    part = Partitioner(mesh)
    for leaf, (lshape, axes) in SPEC["leaves"].items():
        lshape = tuple(lshape)
        index = part.sharding(lshape, tuple(axes)).devices_indices_map(lshape)
        got = np.zeros((n, len(lshape), 2), np.int64)
        for r, device in enumerate(mesh.devices.flat):
            for d, s in enumerate(index[device]):
                start, stop, _ = s.indices(lshape[d])
                got[r, d] = start, stop
        out[f"{len(shape)}:{leaf}"] = got
np.savez(OUT, **out)
"""

RANK_SLICES = r"""
import torch
from repro_torch.launch import make_test_mesh
from repro_torch.launch.partitioning import Partitioner, device_put_tree, shard_slices
mesh = make_test_mesh(tuple(SPEC["shape"]), tuple(SPEC["names"]), device="cpu")
part = Partitioner(mesh)
full = {k: torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)
        for k, (s, _) in SPEC["leaves"].items()}
shardings = {k: part.sharding(tuple(s), tuple(a))
             for k, (s, a) in SPEC["leaves"].items()}
placed = device_put_tree(full, shardings)
out = {}
for k, x in placed.items():
    assert x.device_mesh is mesh and tuple(x.placements) == shardings[k].placements
    out["local_" + k] = x.to_local().numpy()
    mine = shard_slices(x.shape, shardings[k], mesh.get_coordinate())
    out["slices_" + k] = np.array([[s.start, s.stop] for s in mine])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def jax_slices(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("jax"), 8, JAX_SLICES, {
        "meshes": [SMALL, POD],
        "leaves": {k: [list(s), list(a)] for k, (s, a) in LEAVES.items()}})


@pytest.mark.parametrize("mesh", [SMALL, POD], ids=["2x2", "2x2x2"])
def test_each_rank_holds_the_slice_jax_gives_its_device(tmp_path, jax_slices,
                                                        mesh):
    world = int(np.prod(mesh["shape"]))
    ranks = run_ranks(tmp_path, world, RANK_SLICES, {
        **mesh, "leaves": {k: [list(s), list(a)]
                           for k, (s, a) in LEAVES.items()}})
    sharded = set()
    for k, (shape, _) in LEAVES.items():
        full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        want = jax_slices[f"{len(mesh['shape'])}:{k}"]
        for r, got in enumerate(ranks):
            index = tuple(slice(a, b) for a, b in want[r])
            np.testing.assert_array_equal(got["local_" + k], full[index],
                                          err_msg=f"{k} rank {r}")
            np.testing.assert_array_equal(got["slices_" + k], want[r])
            if got["local_" + k].size < full.size:
                sharded.add(k)
    # the leaves exercise sharding on every axis, two axes on one dim too
    assert {"wq", "w_up", "cache_k", "tokens", "positions"} <= sharded


# ----------------------------------------------------- the mesh's own rules


def test_a_mesh_of_another_size_than_the_world_raises():
    with pytest.raises(RuntimeError, match="needs a default process group"):
        make_test_mesh((1, 2), ("data", "model"), device="cpu")
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_test_mesh((2, 1), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host")
def test_a_cuda_mesh_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_test_mesh((1, 1), ("data", "model"))
    assert not dist.is_initialized()


def test_shard_slices_reads_the_placements():
    part = Partitioner(AbstractMesh((2, 2, 2), ("pod", "data", "model")))
    sharding = part.sharding((8, 12), ("batch", None))
    # pod-major: (pod 1, data 0) holds the third quarter of the batch
    assert shard_slices((8, 12), sharding, (1, 0, 1)) == (
        slice(4, 6), slice(0, 12))
