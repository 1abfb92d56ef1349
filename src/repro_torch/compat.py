"""Device capability probe and resolution for the port.

Takes the role that ``repro/jax_compat.py`` (``HAS_PALLAS``,
``pallas_call``, the interpret default) plays in the JAX package, with
one difference: nothing here degrades. A float32 backend asked to run
without CUDA raises instead of falling back to another path; the caller
who wants the CPU says so with ``device="cpu"``.

It also holds the ambient mesh, the counterpart of the reference's
``set_mesh`` and ``get_abstract_mesh``: :func:`set_mesh` installs a mesh
for the code it wraps and :func:`current_mesh` reads it (None outside).
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are taken from ``("pod", "data", "model")``, or an
:class:`AbstractMesh`: axis names and sizes with no ranks behind them,
which the partitioning rules read for meshes no test box has (16 x 16, 2 x
16 x 16). :func:`mesh_axes` reads either.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

#: The compute capability the CUDA kernels are built for (``sm_90a``).
HOPPER = (9, 0)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, raising when there is none; otherwise
    the given device, which must be ``cpu`` or an available ``cuda``."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the device backends run on a CUDA "
                "card (pass device='cpu' to run their plain PyTorch "
                "versions on the host)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def require_hopper(device) -> None:
    """Raise unless ``device`` is a CUDA card of compute capability 9.0,
    the one the ``sm_90a`` kernels run on."""
    dev = torch.device(device)
    got = (
        torch.cuda.get_device_capability(dev) if dev.type == "cuda"
        else "no CUDA device"
    )
    if got != HOPPER:
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a (compute capability "
            f"{HOPPER}); {device} has {got}"
        )


def host_tensor(data) -> torch.Tensor:
    """A numpy array (in its own dtype) or any other bytes-like object (as
    uint8) as a host tensor that aliases it, without a copy. Callers only
    read it or copy it to a device, so torch's warning about read-only
    buffers is moot and is not shown."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="The given (buffer|NumPy array) is not writable"
        )
        if isinstance(data, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(data))
        return torch.frombuffer(memoryview(data).cast("B"), dtype=torch.uint8)


# --------------------------------------------------------------------------- meshes


class AbstractMesh:
    """Axis names and sizes with no ranks behind them (the reference's
    ``abstract_mesh``): ``shape`` and ``mesh_dim_names`` as a
    ``DeviceMesh`` has them, and no process groups."""

    def __init__(self, shape, axis_names):
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in rank")

    def __repr__(self) -> str:
        return f"AbstractMesh({mesh_axes(self)})"


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh` (the JAX mesh's ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


_MESHES: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the code inside."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost mesh installed by :func:`set_mesh`, or None."""
    return _MESHES[-1] if _MESHES else None


# --------------------------------------------------------------------------- collectives


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``group``, out of place,
    through the functional collective (``_c10d_functional.all_reduce``)
    that DTensor's own redistributions use, so that one counter sees
    both."""
    out = torch.ops._c10d_functional.all_reduce(x.contiguous(), op,
                                                group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


class SumOver(torch.autograd.Function):
    """The sum over ``groups`` (in turn) divided by ``n`` forward; the
    backward hands each rank its cotangent divided by ``n``. The sum is
    replicated, so each rank holds the whole cotangent of its own addend;
    a caller that counts each addend on several ranks (equal values on a
    split axis) divides by their number through ``n``."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        for group in groups:
            x = all_reduce(x, "sum", group)
        return x / n if n != 1 else x

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n if ctx.n != 1 else g), None, None
