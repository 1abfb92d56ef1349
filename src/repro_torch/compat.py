"""Device capability probe and resolution for the port.

Takes the role that ``repro/jax_compat.py`` (``HAS_PALLAS``,
``pallas_call``, the interpret default) plays in the JAX package, with
one difference: nothing here degrades. A float32 backend asked to run
without CUDA raises instead of falling back to another path; the caller
who wants the CPU says so with ``device="cpu"``.
"""

from __future__ import annotations

import torch

#: Whether this process sees a CUDA card (informational; every decision
#: below asks torch again at call time).
HAS_CUDA = torch.cuda.is_available()

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
