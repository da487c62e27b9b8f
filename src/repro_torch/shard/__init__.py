"""The sharded task scheduler: one Atos drain across a mesh of shards.

The counterpart of ``repro/shard``, single-controller as the reference's
``shard_map``: one process drives every shard of a
:class:`~repro_torch.launch.mesh.ShardMesh` (the 1-D ring, or a ``(rows,
cols)`` mesh whose routed exchange takes two per-axis hops).  A
vertex-block partitioner reshards the CSR; each shard runs a queue replica
and the program's wavefront body on its slice; produced tasks are routed
to their owner every round (optionally staged one round,
``defer_rounds``; optionally delta-compressed, ``compress``); occupancy
skew triggers ring work stealing; and a psum'd stop predicate keeps the
mesh in lockstep until the global drain ends.  Shards may share a device
(``make_shard_mesh(S, devices=[torch.device("cuda:0")] * S)``), so one
card runs a real S-shard exchange.
"""
from .codec import codec_capacity, decode_buffer, encode_buffer
from .driver import (ShardCounters, ShardRunStats, discrete_run_sharded,
                     persistent_run_sharded, run_sharded)
from .exchange import (LANE_LOCAL, LANE_STOLEN, NUM_LANES, delivered_width,
                       pop_wavefront, route_tasks)
from .partition import (ShardedCSR, block_bounds, block_size, owner_coords,
                        owner_of, partition_graph, split_seeds)
from .steal import plan_donations, rebalance

__all__ = [
    "ShardCounters", "ShardRunStats", "discrete_run_sharded",
    "persistent_run_sharded", "run_sharded",
    "LANE_LOCAL", "LANE_STOLEN", "NUM_LANES", "delivered_width",
    "pop_wavefront", "route_tasks",
    "ShardedCSR", "block_bounds", "block_size", "owner_coords", "owner_of",
    "partition_graph", "split_seeds",
    "plan_donations", "rebalance",
    "codec_capacity", "decode_buffer", "encode_buffer",
]
