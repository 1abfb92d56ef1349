from .kernel import ssd_chunked_cuda
from .ops import ssd_chunked, ssd_mixer
from .ref import ssd_chunked_ref, ssd_chunked_split_ref, ssd_ref

__all__ = [
    "ssd_chunked",
    "ssd_chunked_cuda",
    "ssd_chunked_ref",
    "ssd_chunked_split_ref",
    "ssd_mixer",
    "ssd_ref",
]
