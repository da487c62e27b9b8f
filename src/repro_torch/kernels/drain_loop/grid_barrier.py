"""The drain kernels' grid barrier measured and checked alone,
``csrc/grid_barrier.cu``.

Replaces no TPU kernel (see the note in the source).  ``INSTANCES`` are the
barrier of ``csrc/drain_common.cuh`` as the drain kernels take it
(``spin``) and cooperative groups' ``this_grid().sync()`` (``grid_sync``),
the yardstick.  Each round checks that every thread's plain store before
the barrier is seen by another block after it.
The barrier has no plain version: a launch on the CPU has no meaning, so
the wrapper needs a CUDA device and raises without one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load

INSTANCES = ("spin", "grid_sync")
#: threads a block
THREADS = 512


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("grid_barrier")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grid_barrier_grid.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.grid_barrier_grid.restype = i
    lib.grid_barrier_launch.argtypes = [i, p, p, p, i, i, p]
    lib.grid_barrier_launch.restype = i
    return lib


def _instance(instance: str) -> int:
    if instance not in INSTANCES:
        raise ValueError(f"instance must be one of {INSTANCES}, got "
                         f"{instance!r}")
    return INSTANCES.index(instance)


def barrier_grid(instance: str = "spin", device=None) -> tuple:
    """``(most, sms)``: the co-resident grid of 512-thread blocks of the
    instance on ``device`` (the current CUDA device by default) and its SM
    count."""
    if not torch.cuda.is_available():
        raise ValueError("the grid barrier needs a CUDA device")
    most, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        err = _lib().grid_barrier_grid(_instance(instance),
                                       ctypes.byref(most), ctypes.byref(sms))
    check_launch(err, "grid_barrier (launch plan)")
    return most.value, sms.value


def grid_barrier_cuda(rounds: int, grid: int, instance: str = "spin",
                      device=None) -> None:
    """Run ``rounds`` barrier rounds of ``instance`` over ``grid`` blocks of
    512 threads in one cooperative launch on the current stream of
    ``device``.  A block let through early traps, which the next
    synchronize reports.  Makes no host sync."""
    if not torch.cuda.is_available():
        raise ValueError("the grid barrier needs a CUDA device")
    device = torch.device("cuda", device if device is not None
                          else torch.cuda.current_device())
    # the barrier's arrival word, the three round words, then the two
    # halves of the threads' stamps, all zero
    words = torch.zeros(4 + 2 * int(grid) * THREADS, dtype=torch.int32,
                        device=device)
    with torch.cuda.device(device):
        err = _lib().grid_barrier_launch(
            _instance(instance), words.data_ptr(), words[1:].data_ptr(),
            words[4:].data_ptr(), int(rounds), int(grid),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "grid_barrier")
