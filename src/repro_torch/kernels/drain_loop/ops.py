"""``megakernel_drive``: the drain driver behind ``kernel="megakernel"``.

The counterpart of ``repro/kernels/drain_loop/ops.py``.  Where
``persistent_drive`` enqueues predicated rounds from the host and
``discrete_drive`` runs a host loop, this driver runs the whole drain as
one launch of the program's CUDA drain kernel (``kernel``, a runner
``kernel(carry, limit)``), or, without one, as the plain fused drain
:func:`~repro_torch.kernels.drain_loop.kernel.fused_drain_ref` over the
same ``step`` and ``cond``.

``limit`` serves segmented drains: ``rounds < limit`` is conjoined into the
loop condition, with rounds at ``carry[2]``, so segment boundaries are
absolute round numbers and a drain cut into segments takes exactly the
steps of an uncut one.  On the plain path the limit rides as one more
carry leaf, as in the reference; the kernel takes it as an operand.
"""
from __future__ import annotations

from .kernel import fused_drain_ref, make_fused_drain


def make_megakernel_segment(step, cond, example_carry, *, kernel=None):
    """Return ``seg(carry, limit)``, which drains ``carry`` until ``cond``
    fails or ``rounds`` reaches ``limit`` -- through ``kernel`` when the
    program has one, else through the plain fused drain."""
    if kernel is not None:
        return kernel

    def seg_cond(c):
        return cond(tuple(c[:-1])) & (c[2] < c[-1])

    def seg_step(c):
        return (*step(tuple(c[:-1])), c[-1])

    run = make_fused_drain(seg_step, seg_cond, (*tuple(example_carry), 0))

    def seg(carry, limit):
        return tuple(run((*tuple(carry), limit))[:-1])

    return seg


def megakernel_drive(step, cond, carry0, *, limit=None, kernel=None):
    """Drive ``carry0 = (queue, state, rounds, processed)`` to its fixed
    point, or to round ``limit``, in one launch of ``kernel`` (or the plain
    fused drain when ``kernel`` is None)."""
    if limit is not None:
        return make_megakernel_segment(step, cond, carry0,
                                       kernel=kernel)(carry0, limit)
    if kernel is not None:
        return kernel(carry0, None)
    return fused_drain_ref(step, cond, carry0)
