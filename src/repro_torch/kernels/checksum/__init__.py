from .kernel import checksum_cuda
from .ops import device_checksum, verify_replicas
from .ref import checksum_ref, to_words

__all__ = [
    "checksum_cuda",
    "checksum_ref",
    "device_checksum",
    "to_words",
    "verify_replicas",
]
