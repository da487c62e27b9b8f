"""Atos on PyTorch and CUDA: the port of the ``repro`` package to one NVIDIA H100.

The module layout mirrors ``repro`` so that each module's counterpart is
found under the same path.  Tensors live on the device the caller names;
every entry point defaults to ``device="cuda"`` and raises without a card
unless ``device="cpu"`` is passed.  The hand-written kernels
(``kernels/``, sources in ``csrc/``) run on CUDA tensors; their plain
PyTorch versions run on CPU tensors.

The port so far runs speculative BFS end to end, and serves dense
language models (prefill through B5, decode through the KV cache):

  graph       CSR container and the R-MAT / grid / Erdos generators
  core        backend axis, task queue, chunk codec, frontier expansion,
              wavefront scheduler (persistent, discrete, megakernel)
  kernels     B1 load-balancing search, B2 stream compaction, B3 the BFS
              drain in one launch, B4 the row-slice stream, B5 flash
              attention
  runtime     program protocol, execution policy, ``execute``
  algorithms  BFS (speculative and level-synchronous)
  configs     the ten model configurations (data only)
  models      parameter specs, layers, the dense transformer
  serving     the continuous-batching engine
  launch      the serving CLI (``python -m repro_torch.launch.serve``)
  convert     numpy <-> port objects, for handing state and weights
              across packages
"""
