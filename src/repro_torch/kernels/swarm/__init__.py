from .kernel import rarest_argmin_cuda, select_rows_cuda, waterfill_cuda
from .ops import (
    FleetDeviceState,
    fleet_waterfill,
    flow_table,
    rarest_argmin,
    select_rows,
    waterfill,
)
from .ref import (
    link_channel,
    rarest_argmin_ref,
    select_rows_ref,
    waterfill_compact_ref,
    waterfill_ref,
)

__all__ = [
    "FleetDeviceState",
    "fleet_waterfill",
    "flow_table",
    "link_channel",
    "rarest_argmin",
    "rarest_argmin_cuda",
    "rarest_argmin_ref",
    "select_rows",
    "select_rows_cuda",
    "select_rows_ref",
    "waterfill",
    "waterfill_compact_ref",
    "waterfill_cuda",
    "waterfill_ref",
]
