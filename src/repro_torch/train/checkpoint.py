"""Checkpointing in the JAX package's format (counterpart of
``repro/train/checkpoint.py``): content-addressed, swarm-distributable,
exactly resumable.

A checkpoint is a directory ``step_<8 digits>`` of ``.npy`` leaves and a
JSON manifest, byte for byte the reference's, so that a directory written
by either package loads in the other and hashes to the same swarm bundle:

- one ``.npy`` a leaf of the reference's tree, named by its path with
  ``/`` as ``__``. The port's per-layer parameters (``groups.<i>.<g>.<rest>``,
  and an encoder's ``encoder.blocks.<g>.<rest>``) are stacked back into
  the reference's leaves (``groups/<i>/<rest>`` and
  ``encoder/blocks/<rest>`` hold every layer ``g``), the inverse of
  ``models/convert.py``'s name map;
  an :class:`~repro_torch.train.optimizer.OptState` is stored under the
  reference's ``OptState`` paths (``opt/step``, ``opt/mu/...``,
  ``opt/nu/...``, ``opt/residual/...`` when there is one);
- ``manifest.json`` as the reference writes it: step, every leaf's file,
  shape and dtype name (sorted by path), and ``extra``;
- bfloat16 leaves as the reference's ``np.save`` of an ``ml_dtypes``
  array writes them: 2-byte words under the descr ``<V2``, the manifest
  saying ``"bfloat16"``. The port writes and reads those words itself and
  views them as ``torch.bfloat16``, by the manifest, without ``ml_dtypes``.

A tree is a nested mapping whose leaves are tensors, ``nn.Module`` s (their
parameters) or ``OptState`` s, e.g. ``{"params": model, "opt": opt_state}``.
:func:`load_checkpoint` fills the tensors of ``like`` in place (each keeps
its device; a dtype or shape that differs from the checkpoint's raises) and
returns ``like``. Leaves of the checkpoint that ``like`` lacks are not read,
so ``{"params": model}`` restores a model from a training checkpoint.

The elastic reshard is ``load_checkpoint(..., shardings=)``: ``like`` is
then a tree of nested mappings in the reference's layout (stacked leaves,
e.g. ``{"params": bundle.abstract()}``, whose meta tensors give each leaf's
shape and dtype) and ``shardings`` the matching tree of
:class:`~repro_torch.launch.partitioning.Sharding` (``Partitioner(mesh).
tree_shardings(bundle.abstract(), bundle.axes)``). Each leaf comes back as
a new DTensor on its sharding's mesh and placements, this rank reading
only its own shard of the memory-mapped ``.npy``; ``like`` is not
written. A DTensor leaf does not go into an ``nn.Module`` by itself: the
port's modules hold a plain tensor a layer on every rank, so a model
takes layer ``g`` of a stacked leaf with
``param.copy_(leaf.full_tensor()[g])`` (``leaf.to_local()[g]`` on a
one-rank mesh, where the shard is the whole leaf).
"""

from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..compat import host_tensor
from ..core.metainfo import MetaInfo, assemble
from ..models.convert import stacked

Tree = Any

_SEP = "/"
_BF16_DESCR = "<V2"   # what np.save writes for an ml_dtypes bfloat16 array


def _walk(tree: Tree, prefix: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """``(path parts, tensor)`` of every leaf; a module's parameter names
    and a mapping's dotted keys split at the dots."""
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + tuple(name.split(".")), p
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _walk(getattr(tree, field), prefix + (field,))
    elif isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _walk(value, prefix + tuple(str(key).split(".")))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif tree is not None:
        raise TypeError(f"{'/'.join(prefix)}: a checkpoint leaf must be a "
                        f"tensor, not {type(tree).__name__}")


def _layer_at(parts: tuple) -> int:
    """Where the layer number stands in the path of a per-layer parameter
    of a stacked leaf (``groups.<i>.<g>.<rest>`` or
    ``encoder.blocks.<g>.<rest>``, under any prefix: the two parts before
    it name the stack, as ``models/convert.py`` ``stacked`` says), or -1."""
    for j in range(len(parts) - 2):
        if stacked(list(parts[j:j + 2])) and parts[j + 2].isdigit():
            return j + 2
    return -1


def reference_key(name: str) -> str:
    """The reference's leaf path of a parameter name: the layer number of
    a per-layer parameter dropped (``groups.0.3.attn.wq`` ->
    ``groups/0/attn/wq``)."""
    parts = tuple(name.split("."))
    g = _layer_at(parts)
    return _SEP.join(parts[:g] + parts[g + 1:] if g >= 0 else parts)


def reference_layout(tree: Tree) -> dict[str, tuple[list[torch.Tensor], bool]]:
    """The reference's leaf paths of ``tree``, each with its tensors and
    whether they are stacked: one tensor for a plain leaf, or the layers
    ``g = 0, 1, ...`` of a group leaf (``groups.<i>.<g>.<rest>``) or an
    encoder leaf (``encoder.blocks.<g>.<rest>``), in order, which the
    reference stacks along a leading axis."""
    out: dict[str, tuple[list[torch.Tensor], bool]] = {}
    stacked: dict[str, dict[int, torch.Tensor]] = {}
    for parts, t in _walk(tree):
        g = _layer_at(parts)
        if g >= 0:
            key = _SEP.join(parts[:g] + parts[g + 1:])
            stacked.setdefault(key, {})[int(parts[g])] = t
        else:
            out[_SEP.join(parts)] = ([t], False)
    for key, layers in stacked.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{key}: layers {sorted(layers)} are not 0..n-1")
        out[key] = ([layers[g] for g in range(len(layers))], True)
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _save_npy(path: Path, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": tuple(t.shape)})
        t.view(torch.int16).numpy().tofile(f)


def _load_npy(path: Path, dtype_name: str) -> torch.Tensor:
    """A leaf as a host tensor of the manifest's dtype (memory-mapped)."""
    arr = np.load(path, mmap_mode="r")
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path.name}: a bfloat16 leaf of "
                             f"{arr.dtype.itemsize}-byte items")
        arr = arr.view(np.int16)
    elif str(arr.dtype) != dtype_name:
        raise ValueError(f"{path.name}: dtype {arr.dtype}, the manifest "
                         f"says {dtype_name}")
    # host_tensor aliases the file's pages; a 0-d leaf is copied (numpy
    # would hand it over as 1-d)
    t = host_tensor(arr) if arr.ndim else torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def save_checkpoint(
    directory: str | Path,
    step: int,
    tree: Tree,
    extra: Optional[dict] = None,
) -> Path:
    """Write checkpoint atomically (tmp dir + rename)."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        for f in tmp.iterdir():
            f.unlink()
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {
        "step": step,
        "leaves": {},
        "extra": extra or {},
    }
    for key, (layers, stacked) in sorted(reference_layout(tree).items()):
        # a DTensor leaf (a state in the rules' layout) is written whole
        layers = [t.full_tensor() if isinstance(t, DTensor) else t
                  for t in layers]
        arr = (torch.stack([t.detach().cpu() for t in layers]) if stacked
               else layers[0])
        fname = key.replace(_SEP, "__") + ".npy"
        _save_npy(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": _dtype_name(arr.dtype),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step_")
    ]
    return max(steps) if steps else None


def load_manifest(directory: str | Path, step: int) -> dict:
    path = Path(directory) / f"step_{step:08d}" / "manifest.json"
    return json.loads(path.read_text())


def _checked_leaf(base: Path, manifest: dict, key: str, shape: tuple,
                  dtype: torch.dtype) -> torch.Tensor:
    """A leaf of the checkpoint, memory-mapped, after checking its shape
    and dtype against the model's."""
    entry = manifest["leaves"][key]
    arr = _load_npy(base / entry["file"], entry["dtype"])
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                         f"!= model {tuple(shape)}")
    if arr.dtype != dtype:
        raise ValueError(f"{key}: checkpoint dtype {entry['dtype']} != "
                         f"model {_dtype_name(dtype)}")
    return arr


def _load_sharded(base: Path, manifest: dict, like: Tree, shardings: Tree,
                  prefix: tuple = ()) -> Tree:
    """``like``'s structure with each leaf a DTensor on its sharding, read
    shard by shard."""
    from torch.distributed.tensor import DTensor

    from ..launch.partitioning import shard_slices

    if isinstance(like, Mapping):
        return {k: _load_sharded(base, manifest, v, shardings[k],
                                 prefix + tuple(str(k).split(".")))
                for k, v in like.items()}
    if not isinstance(like, torch.Tensor):
        raise TypeError(f"{_SEP.join(prefix)}: a sharded restore takes a "
                        f"tree of tensors, not {type(like).__name__}")
    mesh, placements = shardings
    arr = _checked_leaf(base, manifest, _SEP.join(prefix), like.shape,
                        like.dtype)
    mine = arr[shard_slices(arr.shape, shardings, mesh.get_coordinate())]
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    local = mine.to(device, copy=True).contiguous()
    return DTensor.from_local(local, mesh, list(placements), run_check=False)


@torch.no_grad()
def load_checkpoint(
    directory: str | Path,
    like: Tree,
    step: Optional[int] = None,
    shardings: Optional[Tree] = None,
) -> tuple[Tree, dict]:
    """Restore into the tensors of ``like``, in place; returns (like,
    extra). With ``shardings`` (the elastic reshard), returns a new tree of
    DTensors instead (see the module's docstring). Raises where a leaf's
    shape or dtype differs from the checkpoint's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    base = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((base / "manifest.json").read_text())
    if shardings is not None:
        return (_load_sharded(base, manifest, like, shardings),
                manifest["extra"])
    for key, (layers, stacked) in reference_layout(like).items():
        expect = ((len(layers), *layers[0].shape) if stacked
                  else tuple(layers[0].shape))
        arr = _checked_leaf(base, manifest, key, expect, layers[0].dtype)
        for g, t in enumerate(layers):
            t.copy_(arr[g] if stacked else arr)
    return like, manifest["extra"]


# --------------------------------------------------------------------------- swarm bundle


def checkpoint_metainfo(
    directory: str | Path, step: int, piece_length: int = 1 << 22
) -> tuple[MetaInfo, bytes]:
    """Serialize a checkpoint dir into a (metainfo, payload) swarm bundle."""
    base = Path(directory) / f"step_{step:08d}"
    blobs = []
    for f in sorted(base.iterdir()):
        blobs.append((f.name, f.read_bytes()))
    return MetaInfo.from_named_blobs(
        blobs, piece_length, name=f"ckpt_{base.parent.name}_{step}"
    )


def restore_from_bundle(
    metainfo: MetaInfo, pieces: dict[int, bytes], directory: str | Path
) -> Path:
    """Write a swarm-fetched checkpoint bundle back to a local directory."""
    payload = assemble(metainfo, pieces)
    step = int(metainfo.name.rsplit("_", 1)[1])
    out = Path(directory) / f"step_{step:08d}"
    out.mkdir(parents=True, exist_ok=True)
    for entry in metainfo.files:
        (out / entry.name).write_bytes(
            payload[entry.offset : entry.offset + entry.length]
        )
    return out
