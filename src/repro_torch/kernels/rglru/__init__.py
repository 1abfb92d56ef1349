from .kernel import rglru_scan_cuda, rglru_scan_replaced_cuda
from .ops import rglru_scan
from .ref import rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_cuda", "rglru_scan_ref",
           "rglru_scan_replaced_cuda"]
