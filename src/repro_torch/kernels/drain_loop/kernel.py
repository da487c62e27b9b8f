"""Kernel B3's plain version: the whole ``while cond: step`` drain.

The counterpart of ``repro/kernels/drain_loop/kernel.py``.  The reference
traces any drain to a jaxpr and evaluates it inside one Pallas kernel, so
its fused drain serves every program.  The GPU cannot evaluate a jaxpr, so
the port writes one CUDA drain kernel per program (``bfs_drain.py``,
``pagerank_drain.py``, ``coloring_drain.py`` beside this module, sources
in ``csrc/``) and keeps here
the generic plain version every such kernel is held against: a host loop
over the same ``step`` and ``cond``, on any device.  It runs the
megakernel cells on CPU tensors and on ``backend="torch"``.
"""
from __future__ import annotations


def fused_drain_ref(step, cond, carry0):
    """Run ``while cond(c): c = step(c)`` to its fixed point; ``carry0`` is
    any tree of tensors (the drain carry is ``(queue, state, rounds,
    processed)``).  One scalar device->host read per round."""
    carry = carry0
    while bool(cond(carry)):
        carry = step(carry)
    return carry


def make_fused_drain(step, cond, example_carry):
    """A runner ``run(carry)`` for carries shaped like ``example_carry``,
    as the reference builds one traced kernel for many like-shaped drains.
    The plain version has nothing to build."""
    del example_carry

    def run(carry):
        return fused_drain_ref(step, cond, carry)

    return run
