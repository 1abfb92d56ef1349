from .kernel import rarest_argmin_cuda, waterfill_cuda
from .ops import (
    FleetDeviceState,
    fleet_waterfill,
    flow_table,
    rarest_argmin,
    waterfill,
)
from .ref import link_channel, rarest_argmin_ref, waterfill_ref

__all__ = [
    "FleetDeviceState",
    "fleet_waterfill",
    "flow_table",
    "link_channel",
    "rarest_argmin",
    "rarest_argmin_cuda",
    "rarest_argmin_ref",
    "waterfill",
    "waterfill_cuda",
    "waterfill_ref",
]
