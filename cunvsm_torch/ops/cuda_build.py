"""Build of the package's CUDA C++ kernels.

Each kernel is a source under ``cunvsm_torch/csrc/`` with a plain C entry
point.  At its first use the source is compiled by ``nvcc`` for ``sm_90a``
into a shared library under the checkout's ``build/cuda/`` (which
``.gitignore`` lists) and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  The library's file name
carries a hash of the sources and the flags, so an edited source builds
anew, and it is written under a temporary name and moved into place, so a
process never loads a half-written library that another one is building.
Importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``; raises
    ``RuntimeError`` if neither exists."""
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path:
        return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use; set CUDA_HOME "
        "or put nvcc on PATH"
    )


def library_path(name: str, sources: tuple) -> str:
    """``build/cuda/lib<name>-<hash>.so``, the hash over the sources' bytes
    and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def nvcc_command(nvcc: str, sources: tuple, out: str) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", out, *(os.path.join(CSRC, s) for s in sources)]


def compile_into_place(path: str, command, what: str) -> str:
    """Run the compiler command ``command(out)`` with ``out`` a temporary
    name beside ``path`` and move the result to ``path``, so that no
    process ever loads a half-written library.  Raises ``RuntimeError``
    with the compiler's errors, leaving nothing behind, if it fails."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    stem = os.path.basename(path).split("-")[0]
    fd, tmp = tempfile.mkstemp(prefix=f".{stem}-", suffix=".so", dir=directory)
    os.close(fd)
    cmd = command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed to build {what}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def build_library(name: str, sources: tuple) -> str:
    """Compile ``sources`` (file names under ``csrc/``) unless the library
    for their present bytes exists; returns its path."""
    path = library_path(name, sources)
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    return compile_into_place(path, lambda out: nvcc_command(nvcc, sources, out), name)


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """The built library of ``sources``, loaded once per process."""
    return ctypes.CDLL(build_library(name, sources))
