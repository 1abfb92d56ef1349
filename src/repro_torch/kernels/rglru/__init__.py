from .kernel import rglru_scan_cuda
from .ops import RGLRUScan, rglru_scan
from .ref import rglru_scan_ref

__all__ = ["RGLRUScan", "rglru_scan", "rglru_scan_cuda", "rglru_scan_ref"]
