"""The Atos runtime layer: programs x execution policies.

``execute`` / ``build_program`` are imported lazily: the algorithm modules
import :mod:`repro_torch.runtime.program` for the protocol types, and an
eager import here would cycle back through them.
"""
from .policy import (ExecutionPolicy, KERNELS, POLICY_GRID, TOPOLOGIES,
                     config_for, parse_policy, policy_of)
from .program import AtosProgram, ProgramContext

__all__ = [
    "ExecutionPolicy", "KERNELS", "POLICY_GRID", "TOPOLOGIES",
    "config_for", "parse_policy", "policy_of",
    "AtosProgram", "ProgramContext",
    "ExecutionResult", "execute", "stream_execute", "algorithms",
    "build_program",
]

_LAZY = {
    "ExecutionResult": "api",
    "execute": "api",
    "stream_execute": "api",
    "algorithms": "programs",
    "build_program": "programs",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
