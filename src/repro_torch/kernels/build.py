"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, keyed by
a hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so a
changed source is rebuilt and an unchanged one is not.  Nothing is built when a module is imported: a
library is built at its kernel's first launch, or ahead of time by
:func:`build`, which starts one nvcc per source, all at once.  nvcc's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: the sources of the kernels the port's paths launch
PATH_SOURCES = ("lbs", "compact", "csr_stream", "bfs_drain", "flash_attention",
                "ordered_scatter_add", "pagerank_drain", "coloring_drain")
#: every source: the paths' and grid_barrier, which only the tools and the
#: tests launch
SOURCES = PATH_SOURCES + ("grid_barrier",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc was not found on PATH or under "
                           "/usr/local/cuda/bin; the CUDA kernels cannot "
                           "be built on this host")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns each library's
    ptxas report.  Raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".ptxas.txt").read_text()
            for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))


def check_launch(err: int, kernel: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed with cudaError_t "
                           f"{err}")
