"""The packed task encoding of the fused topology's lanes.

The counterpart of ``repro/server``'s encoding; the multi-tenant server
itself (jobs, policies, engine, autotuner) comes with ROADMAP A11.
"""
from .encoding import (MAX_JOBS, MAX_NATURAL, PAYLOAD_BITS, PAYLOAD_MASK,
                       check_job_fits, pack, packed_width, unpack_job,
                       unpack_natural, unzigzag, zigzag)

__all__ = ["MAX_JOBS", "MAX_NATURAL", "PAYLOAD_BITS", "PAYLOAD_MASK",
           "check_job_fits", "pack", "packed_width", "unpack_job",
           "unpack_natural", "unzigzag", "zigzag"]
