"""Atos core: wavefront task queue, schedulers, chunk tasks, expansion."""
from .backend import (BACKENDS, STREAM, STREAM_TORCH, has_cuda,
                      resolve_backend, resolve_device)
from .queue import (EMPTY, MultiQueue, TaskQueue, make_multiqueue,
                    make_queue)
from .scheduler import (QueueOps, RunStats, SchedulerConfig, continuation,
                        discrete_drive, megakernel_drive, megakernel_segment,
                        no_host_sync, persistent_drive, taskqueue_ops,
                        wavefront_step)
from .frontier import (Expansion, adjacency_of, chunk_degrees, chunk_row_of,
                       expand_merge_path, expand_per_item, gather_neighbors,
                       searchsorted_right)
from .task import (MAX_GRANULARITY, ChunkCodec, chunk_seeds, coalesce_chunks,
                   flatten_chunks)
from .counters import WorkCounter, overwork_ratio

__all__ = [
    "BACKENDS", "STREAM", "STREAM_TORCH", "has_cuda", "resolve_backend",
    "resolve_device",
    "EMPTY", "MultiQueue", "TaskQueue", "make_multiqueue", "make_queue",
    "QueueOps", "RunStats", "SchedulerConfig", "continuation",
    "discrete_drive", "megakernel_drive", "megakernel_segment",
    "no_host_sync", "persistent_drive", "taskqueue_ops",
    "wavefront_step",
    "Expansion", "adjacency_of", "chunk_degrees", "chunk_row_of",
    "expand_merge_path", "expand_per_item", "gather_neighbors",
    "searchsorted_right",
    "MAX_GRANULARITY", "ChunkCodec", "chunk_seeds", "coalesce_chunks",
    "flatten_chunks",
    "WorkCounter", "overwork_ratio",
]
