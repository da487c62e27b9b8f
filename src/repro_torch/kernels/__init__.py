"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``) + their plain
PyTorch versions.

frontier_expand -- B1, merge-path load-balancing search; hot path of
                   ``core.frontier.expand_merge_path`` on the ``"cuda"``
                   backend
queue_compact   -- B2, stable stream compaction; hot path of
                   ``core.queue.TaskQueue.push`` on the ``"cuda"`` backend
drain_loop      -- B3, each program's whole drain in one cooperative
                   launch (``kernel="megakernel"`` on CUDA tensors; BFS,
                   PageRank and coloring at granularity 1), their generic
                   plain version ``fused_drain_ref``, and B4, the
                   double-buffered row-slice stream the BFS and PageRank
                   drains stage through
scatter_add     -- the ordered scatter-add: PageRank's ``.at[].add`` in
                   update order, bit-equal to the CPU's sequential sum (no
                   TPU kernel; atomics would change the low bits per run)
flash_attention -- B5, causal / sliding-window GQA attention; hot path of
                   ``models.layers.apply_attention`` at prefill

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for CPU tensors.  Libraries are built by nvcc at first launch
(``kernels/build.py``), never at import.
"""
