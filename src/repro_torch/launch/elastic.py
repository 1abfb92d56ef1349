"""Elastic relaunch: reshard a checkpoint onto a different mesh
(counterpart of ``repro/launch/elastic.py``).

``python -m repro_torch.launch.elastic --ckpt-dir D --arch A [--device cpu]``

Checkpoints store unsharded leaves, and the model declares each leaf's
logical axes, so moving a job onto another mesh is: build the new mesh,
derive placements from the same logical-axis rules, and read each rank's
shard on restore (``load_checkpoint(..., shardings=)``). The data cursor
in the checkpoint's ``extra`` resumes the exact batch stream. The command
line restores onto a one-rank (1, 1) ("data", "model") mesh, on the CUDA
card (one-rank NCCL group) or with ``--device cpu`` on the host (gloo).
"""

from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..models.layers import tree_leaves
from ..train import checkpoint as ckpt
from .mesh import make_test_mesh
from .partitioning import Partitioner


def reshard(ckpt_dir: str, arch: str, mesh, reduced: bool = True):
    """The checkpoint's parameters as DTensors on ``mesh`` (a tree of the
    reference's layout) and the checkpoint's ``extra``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduce()
    bundle = build_model(cfg, mesh.device_type)
    part = Partitioner(mesh)
    shardings = {"params": part.tree_shardings(bundle.abstract(), bundle.axes)}
    restored, extra = ckpt.load_checkpoint(
        ckpt_dir, {"params": bundle.abstract()}, shardings=shardings)
    return restored["params"], extra


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    mesh = make_test_mesh((1, 1), ("data", "model"), device=args.device)
    params, extra = reshard(args.ckpt_dir, args.arch, mesh)
    n = sum(x.numel() for _, x in tree_leaves(params))
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"[elastic] resharded {n/1e6:.2f}M params onto mesh "
          f"{axes}; data cursor: {extra.get('data')}")


if __name__ == "__main__":
    main()
