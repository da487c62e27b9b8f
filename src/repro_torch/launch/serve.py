"""Serving CLI: Atos continuous batching over a synthetic request trace.

The counterpart of ``repro/launch/serve.py``, with ``--device`` (default
``cuda``; pass ``cpu`` to run on the host):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --smoke --requests 16 --slots 4 --mode continuous --device cpu

Every ``--arch`` of the registry serves, smoke or full size: dense, MoE,
SSM, hybrid, encoder-decoder and VLM (the VLM and the encoder-decoder
decode text tokens only, with an empty encoder cache, as the reference
does).

``synthetic_requests`` makes the reference's numpy draws, so both CLIs
serve the same request list.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import get_config, smoke_config
from ..models import transformer as T
from ..models.params import init_params
from ..serving.engine import ContinuousBatchingEngine, Request

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def synthetic_requests(n: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        Request(uid=i,
                prompt=list(rng.integers(0, vocab, rng.integers(2, 6))),
                max_new_tokens=int(rng.integers(2, 10)))
        for i in range(n)
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "bsp"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dtype = DTYPES[cfg.dtype]
    params = init_params(T.model_spec(cfg), 0, dtype, device=args.device)
    reqs = synthetic_requests(args.requests, cfg.vocab_size)
    engine = ContinuousBatchingEngine(cfg, params, num_slots=args.slots,
                                      max_len=args.max_len, mode=args.mode,
                                      dtype=dtype)
    t0 = time.time()
    res = engine.run(reqs)
    dt = time.time() - t0
    st = res["stats"]
    total_toks = sum(len(v) for v in res["outputs"].values())
    print(f"mode={args.mode} requests={args.requests} slots={args.slots} "
          f"device={args.device}")
    print(f"wavefronts={st.wavefronts} mean_occupancy={st.mean_occupancy:.3f}")
    print(f"tokens={total_toks} wall={dt:.2f}s tok/s={total_toks / dt:.1f}")


if __name__ == "__main__":
    main()
