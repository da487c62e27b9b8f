"""Atos on PyTorch and CUDA: the port of the ``repro`` package to one NVIDIA H100.

The module layout mirrors ``repro`` so that each module's counterpart is
found under the same path.  Tensors live on the device the caller names;
every entry point defaults to ``device="cuda"`` and raises without a card
unless ``device="cpu"`` is passed.  The hand-written kernels
(``kernels/``, sources in ``csrc/``) run on CUDA tensors; their plain
PyTorch versions run on CPU tensors.

The port runs speculative BFS, asynchronous PageRank and speculative
coloring on the single and fused topologies, over static graphs and over
streams of edge deltas, and serves dense language models (prefill through
B5, decode through the KV cache):

  graph       CSR container, the R-MAT / grid / Erdos generators, the
              delta stream, the slotted CSR of streaming graphs
  core        backend axis, task queue and MultiQueue, chunk codec,
              frontier expansion, wavefront scheduler (persistent,
              discrete, megakernel)
  kernels     B1 load-balancing search, B2 stream compaction, B3 each
              program's drain in one launch (fused, traced and slotted
              modes), B4 the row-slice stream, B5 flash attention, the
              ordered scatter-add
  runtime     program protocol, execution policy, ``execute``,
              ``stream_execute``
  algorithms  BFS, PageRank, coloring (queue-driven and level-synchronous)
  stream      delta ingestion, dirty-seed rules, snapshots, the stream
              driver
  checkpoint  atomic checkpoints of the port's trees
  obs, server the trace ring and collector; the fused lane's encoding
  configs     the ten model configurations (data only)
  models      parameter specs, layers, the dense transformer
  serving     the continuous-batching engine
  launch      the serving CLI (``python -m repro_torch.launch.serve``)
  convert     numpy <-> port objects, for handing state and weights
              across packages
"""
