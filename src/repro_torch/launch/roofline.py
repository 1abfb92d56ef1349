"""Per-device counts and roofline terms priced at H100 constants
(counterpart of ``repro/launch/hlo_analysis.py``).

The port has no HLO: nothing is compiled ahead of a step, and eager
PyTorch runs one op at a time. So the counts come from running the step
under :class:`DeviceCounter`, a ``TorchDispatchMode`` that sees every op a
rank executes on its *local* tensors: a DTensor op is handed back to
DTensor (``NotImplemented``), which runs its sharding propagation, the
collectives of its redistributions and then the op on each rank's local
shard, and those local ops are what is counted. Counting DTensor ops
themselves would count the global op (a matmul sharded 256 ways reads
256 times one rank's FLOPs). The ops that DTensor's sharding propagation
runs on global shapes to learn an output's shape are not the rank's work
and are skipped.

Per op the counter adds:

- FLOPs from ``torch.utils.flop_counter``'s registry (matrix products,
  and the kernel ops' own formulas, :mod:`repro_torch.kernels.costs`);
- HBM bytes: each tensor operand read once and each output written once
  (the kernel ops' :data:`~repro_torch.kernels.costs.BYTES`; the same
  rule for every other op that is not a view). Eager execution fuses
  nothing, so this is the traffic of the program as it runs;
- collectives by the reference's kind names, each by the bytes of the
  larger of its input and output buffers (what a rank sends or receives,
  whole), with the mesh axis its group spans; DTensor's all-to-all
  redistribution, which a CPU mesh runs as an all-gather and a chunk,
  counts as the all-to-all that NCCL runs;
- memory: the bytes of every live storage, the arguments (parameters,
  optimizer state, inputs) registered by the caller and every storage an
  op allocates, freed when its last tensor dies; the peak is the step's.
  (``torch.distributed._tools.mem_tracker.MemTracker`` would also count
  the global-shape tensors of the sharding propagation, which no rank
  allocates.)

The hardware model is one NVIDIA H100 SXM a rank, eight a node: the
tensor cores' dense bf16 rate, the HBM rate and capacity, NVLink within
a node and one 400 Gb/s NDR InfiniBand port a GPU across nodes. Each
collective is priced by the slowest link its group spans: a mesh axis
whose ranks lie in one node of eight runs on NVLink, any other on
InfiniBand (on the production meshes every axis of 16 ranks or more
crosses nodes). The terms are per-device seconds per step:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = hbm_bytes_per_device / HBM_BW
    collective = sum over collectives of bytes / link rate of its axis

There is no ``total_bf16eq``: the reference's bracket corrects for XLA's
CPU backend carrying bf16 collectives as f32, while NCCL (and this
counter) carries a bf16 tensor as bf16.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, placement_types
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels.costs import BYTES, io_bytes

# NVIDIA H100 SXM5 data sheet: dense BF16 tensor-core rate (1,979 TFLOP/s
# is with sparsity), HBM3 bandwidth and capacity
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# NVLink 4: 900 GB/s a GPU in both directions, 450 GB/s each way, within
# an HGX node of eight GPUs
NVLINK_BW = 450e9
NODE_GPUS = 8
# across nodes: one ConnectX-7 NDR port a GPU, 400 Gb/s = 50 GB/s
IB_BW = 50e9

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_c10d = torch.ops._c10d_functional
_COLLECTIVES = {
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.all_gather_into_tensor_coalesced: "all-gather",
    _c10d.all_reduce: "all-reduce",
    _c10d.all_reduce_coalesced: "all-reduce",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
    _c10d.broadcast: "collective-permute",
    torch.ops.c10d.allreduce_: "all-reduce",
    torch.ops.c10d._allgather_base_: "all-gather",
    torch.ops.c10d.allgather_: "all-gather",
    torch.ops.c10d._reduce_scatter_base_: "reduce-scatter",
    torch.ops.c10d.alltoall_base_: "all-to-all",
    torch.ops.c10d.broadcast_: "collective-permute",
}
_FREE = {_c10d.wait_tensor, torch.ops.aten.detach, torch.ops.aten.alias,
         torch.ops.aten.empty, torch.ops.aten.empty_strided,
         torch.ops.aten.empty_like, torch.ops.aten.new_empty,
         torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh,
         torch.ops.aten._local_scalar_dense}


def axis_bandwidth(mesh_shape: dict, axis: Optional[str]) -> float:
    """The link rate of a collective over mesh axis ``axis`` (ranks in
    row-major order, ``NODE_GPUS`` consecutive ranks a node): NVLink if
    every group of the axis lies in one node, else InfiniBand. An unknown
    axis is priced at the slowest link."""
    if axis not in mesh_shape:
        return IB_BW
    names = list(mesh_shape)
    stride = math.prod(mesh_shape[a] for a in names[names.index(axis) + 1:])
    span = stride * (mesh_shape[axis] - 1) + 1
    return NVLINK_BW if span <= NODE_GPUS and NODE_GPUS % (
        stride * mesh_shape[axis]) == 0 else IB_BW


class DeviceCounter(TorchDispatchMode):
    """One rank's FLOPs, HBM bytes, collectives and live memory over the
    ops it runs on local tensors (see the module docstring). ``mesh``
    names the groups: a collective is filed under the mesh axis whose
    group it ran on (``"?"`` otherwise)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives: list[tuple[str, int, str]] = []
        self.live = 0
        self.peak = 0
        self.arguments: dict[str, int] = {}
        self._seen: dict[int, int] = {}
        self._skip = 0
        self._axis = {}
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axis[mesh.get_group(name).group_name] = name
        self._kept = None

    # ------------------------------------------------------------ memory
    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; its bytes if
        it was not counted yet, else 0."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def track(self, tree, category: str) -> None:
        """Register the tensors of ``tree`` (arguments of the step) as
        live, their bytes under ``category``."""
        n = sum(self._hold(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor))
        self.arguments[category] = self.arguments.get(category, 0) + n

    # ------------------------------------------------------------ mode
    def __enter__(self):
        original = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, op_schema):
            counter._skip += 1
            try:
                return original(prop, op_schema)
            finally:
                counter._skip -= 1

        all_to_all = placement_types.shard_dim_alltoall

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            # on a CPU mesh DTensor runs an all-to-all as an all-gather and
            # a chunk: counted as the all-to-all NCCL runs, its output
            # written once
            counter._skip += 1
            try:
                out = all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                counter._skip -= 1
            counter.collectives.append((
                "all-to-all", max(_bytes(input), _bytes(out)),
                mesh.mesh_dim_names[mesh_dim]))
            counter.hbm_bytes += _bytes(out)
            counter._hold(out)
            return out

        self._kept = (original, all_to_all)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        placement_types.shard_dim_alltoall = shard_dim_alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        (ShardingPropagator._propagate_tensor_meta_non_cached,
         placement_types.shard_dim_alltoall) = self._kept
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._skip:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if packet in _COLLECTIVES:
            size = max(_bytes(args[0]), _bytes(out))
            # the group's name is the op's last string argument
            group = kwargs.get("group_name") or next(
                (a for a in reversed(args) if isinstance(a, str)), None)
            self.collectives.append((_COLLECTIVES[packet], size,
                                     self._axis.get(group, "?")))
        elif packet not in _FREE and not func.is_view:
            self.hbm_bytes += BYTES.get(packet, io_bytes)(args, kwargs, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not func.is_view:
                self._hold(t)
        return out

    # ------------------------------------------------------------ results
    def collective_bytes(self) -> dict:
        """Bytes by the reference's kind names, with ``count`` and
        ``total``."""
        out = {k: 0 for k in KINDS}
        for kind, size, _ in self.collectives:
            out[kind] += size
        out["count"] = len(self.collectives)
        out["total"] = sum(out[k] for k in KINDS)
        return out

    def collective_seconds(self, mesh_shape: dict) -> float:
        """Each collective's bytes over the link rate of its axis."""
        return sum(size / axis_bandwidth(mesh_shape, axis)
                   for _, size, axis in self.collectives)

    def memory(self) -> dict:
        """Argument bytes by category, the peak and the fit."""
        args = sum(self.arguments.values())
        return {
            **{f"{k}_bytes": v for k, v in self.arguments.items()},
            "argument_bytes": args,
            "temp_bytes": self.peak - args,
            "peak_estimate_bytes": self.peak,
            "fits": self.peak <= HBM_BYTES,
        }


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Roofline:
    flops: float                   # per device
    hbm_bytes: float               # per device
    coll_bytes: float              # per device
    model_flops: float             # useful 6ND (or 2ND) global
    chips: int
    coll_seconds: Optional[float] = None   # priced by axis; else IB_BW

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_seconds is not None:
            return self.coll_seconds
        return self.coll_bytes / IB_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips x FLOPs a device): remat/overcompute waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization *upper bound* at the roofline: useful
        global FLOPs / (chips x peak x bound-time)."""
        t = self.t_bound
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_for(
    kind: str, total_params: int, active_params: int, tokens: int,
    embed_params: int = 0,
) -> float:
    """Useful-FLOPs convention: train 6·N_active·D, prefill 2·N_active·D,
    decode 2·N_active·B (tokens == new tokens)."""
    n = active_params
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
