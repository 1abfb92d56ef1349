"""Build and load the port's CUDA kernel sources.

Every kernel source (``kernels/*/csrc/*.cu``) exposes a plain C interface
and is compiled the same way: ``nvcc`` for ``sm_90a`` into a shared
library under ``build/repro_torch/`` at the root of the checkout, loaded
with ``ctypes``. The library's file name carries a hash of its own source
and flags, so an edit to one source rebuilds that library alone, and two
processes building the same library never see half a file. Nothing is
compiled when a module is imported: a kernel is built at its first use,
or ahead of it by :func:`build`, which starts one ``nvcc`` for each source
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: Flags every source is built with; a kernel module adds its own.
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH): "
            "the CUDA kernels are built from source at first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(source: Path, flags: tuple[str, ...]) -> Path:
    """Where the library of ``source`` built with ``flags`` lives."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(*targets: tuple[Path, tuple[str, ...]]) -> list[Path]:
    """Compile each ``(source, flags)`` that has no library yet, one
    ``nvcc`` process for each, all started together; return the
    libraries' paths in the order given. Raises with the compiler's
    output if any build fails."""
    libs = [library_path(src, flags) for src, flags in targets]
    jobs = []
    for (src, flags), lib in zip(targets, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, cmd, tmp, lib))
    failed = []
    for proc, cmd, tmp, lib in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: Path, flags: tuple[str, ...]) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library."""
    return ctypes.CDLL(str(build((source, flags))[0]))


def ptxas_report(source: Path, flags: tuple[str, ...]) -> str:
    """What ptxas says of each kernel of ``source`` built with ``flags``:
    registers, shared memory and spills. The source is compiled once more
    with ``-Xptxas -v`` into a scratch library, which is then removed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"ptxas_report.{os.getpid()}.so"
    cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    finally:
        tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout
