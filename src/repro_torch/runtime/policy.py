"""The execution-policy axis: (topology) x (kernel strategy) x (granularity).

The counterpart of ``repro/runtime/policy.py``; the whole matrix parses
unchanged:

    topology:     single  | fused  | sharded
    kernel:       persistent | discrete | megakernel
    granularity:  g1 | g2 | g4 | ... (max chunk width, core/task.py)

``single`` is one TaskQueue on one device; ``fused`` drains through a
packed MultiQueue lane (the task server's engine); ``sharded`` runs queue
replicas across devices.  ``persistent`` keeps the drain on the device
between host polls; ``discrete`` reads the continuation flag every round;
``megakernel`` fuses the whole drain into one kernel launch.
``sharded.megakernel`` is the one invalid cell.  ``granularity`` is
spelled as a ``.g<width>`` suffix, omitted at width 1.

This slice executes ``single.persistent`` and ``single.discrete`` at any
granularity; ``runtime.execute`` names the ROADMAP item of every other
cell.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.task import MAX_GRANULARITY

TOPOLOGIES: Tuple[str, ...] = ("single", "fused", "sharded")
KERNELS: Tuple[str, ...] = ("persistent", "discrete", "megakernel")


def _valid_cell(topology: str, kernel: str) -> bool:
    """``sharded.megakernel`` is the single invalid (topology, kernel) pair:
    the sharded round's routed exchange is a cross-device collective, and a
    megakernel is by definition one device-resident launch."""
    return not (topology == "sharded" and kernel == "megakernel")


def _matrix_help() -> str:
    """One shared enumeration of the policy matrix for error messages."""
    cells = ", ".join(f"{t}.{k}" for t in TOPOLOGIES for k in KERNELS
                      if _valid_cell(t, k))
    return (f"valid cells are '<topology>.<kernel>[.g<width>]' with "
            f"topology x kernel in {{{cells}}} and an optional granularity "
            f"suffix g1..g{MAX_GRANULARITY} (omitted = g1)")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """One cell of the (topology x kernel x granularity) matrix."""

    topology: str = "single"
    kernel: str = "persistent"
    granularity: int = 1

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"expected one of {TOPOLOGIES} — "
                             f"{_matrix_help()}")
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel strategy {self.kernel!r}; "
                             f"expected one of {KERNELS} — "
                             f"{_matrix_help()}")
        if not _valid_cell(self.topology, self.kernel):
            raise ValueError(
                "sharded.megakernel is not a valid cell: the megakernel "
                "fuses one device's whole drain into a single kernel "
                "launch, but the sharded topology routes tasks between "
                "devices every round (a collective that cannot run inside "
                f"a resident kernel) — {_matrix_help()}")
        if not 1 <= self.granularity <= MAX_GRANULARITY:
            raise ValueError(
                f"bad granularity {self.granularity!r}; expected an int in "
                f"[1, {MAX_GRANULARITY}] — {_matrix_help()}")

    @property
    def persistent(self) -> bool:
        """True for the device-resident strategies (``persistent`` and
        ``megakernel``), matching the legacy ``persistent`` bool."""
        return self.kernel != "discrete"

    def __str__(self) -> str:
        base = f"{self.topology}.{self.kernel}"
        return base if self.granularity == 1 else \
            f"{base}.g{self.granularity}"


#: every valid (topology, kernel) combination at the default granularity,
#: row-major — the finite slice of the matrix tests and CLIs enumerate
#: (granularity is unbounded; name a cell with a ``.g<width>`` suffix).
#: 8 cells: 3 x 3 minus the invalid ``sharded.megakernel``.
POLICY_GRID: Tuple[ExecutionPolicy, ...] = tuple(
    ExecutionPolicy(t, k) for t in TOPOLOGIES for k in KERNELS
    if _valid_cell(t, k)
)


def parse_policy(text: str) -> ExecutionPolicy:
    """Parse ``"fused.discrete"`` / ``"sharded.persistent.g4"``-style policy
    names (CLI / cache keys).  The granularity segment is optional and
    defaults to 1, so pre-granularity policy strings parse unchanged."""
    parts = text.split(".")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"bad policy {text!r}; expected '<topology>.<kernel>' like "
            f"'single.persistent' or '<topology>.<kernel>.g<width>' like "
            f"'sharded.persistent.g4' — {_matrix_help()}")
    granularity = 1
    if len(parts) == 3:
        seg = parts[2]
        if not (seg.startswith("g") and seg[1:].isdigit()):
            raise ValueError(
                f"bad granularity segment {seg!r} in policy {text!r}; "
                f"expected 'g<width>' like 'g4' — {_matrix_help()}")
        granularity = int(seg[1:])
    return ExecutionPolicy(parts[0], parts[1], granularity)


def policy_of(cfg) -> ExecutionPolicy:
    """Resolve a :class:`~repro_torch.core.scheduler.SchedulerConfig`'s policy.

    ``topology="auto"`` resolves to ``sharded`` iff ``num_shards > 1``; an
    explicit non-sharded topology with ``num_shards > 1`` is a
    contradiction and raises rather than silently dropping the mesh.
    ``kernel="auto"`` (the config default) defers to the legacy
    ``persistent`` bool, so every pre-megakernel config resolves exactly
    as before; an explicit kernel name wins over the bool.
    ``granularity`` is carried through verbatim (validated against the
    matrix bounds by :class:`ExecutionPolicy`).
    """
    topology = cfg.topology
    if topology == "auto":
        topology = "sharded" if cfg.num_shards > 1 else "single"
    elif topology != "sharded" and cfg.num_shards > 1:
        raise ValueError(
            f"topology={topology!r} is incompatible with "
            f"num_shards={cfg.num_shards}; use topology='sharded' (or "
            f"'auto') — {_matrix_help()}")
    kernel = getattr(cfg, "kernel", "auto")
    if kernel == "auto":
        kernel = "persistent" if cfg.persistent else "discrete"
    return ExecutionPolicy(topology, kernel, getattr(cfg, "granularity", 1))


def config_for(cfg, policy: ExecutionPolicy):
    """A config whose resolved policy is ``policy`` (other axes unchanged).

    Both kernel fields are written: the explicit ``kernel`` name (which
    :func:`policy_of` reads back) and the legacy ``persistent`` bool
    (True for both device-resident strategies) for code that predates the
    three-valued axis.
    """
    return dataclasses.replace(cfg, topology=policy.topology,
                               kernel=policy.kernel,
                               persistent=policy.persistent,
                               granularity=policy.granularity)
