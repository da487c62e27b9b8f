"""Continuous batching vs BSP batch serving -- the Atos scheduler on LLM
requests with skewed output lengths (the serving convoy experiment).

The counterpart of ``examples/serve_continuous.py``, with ``--device``
(default ``cuda``; pass ``cpu`` to run on the host):

  PYTHONPATH=src python -m repro_torch.examples.serve_continuous --device cpu

The requests are the reference's numpy draws; the weights are the port's
own random ones (seed 0), so the schedule (wavefronts, occupancy, the
active-slot trace) is the reference's and the tokens are not.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.registry import smoke_config
from ..models import transformer as T
from ..models.params import init_params
from ..serving.engine import ContinuousBatchingEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    device = ap.parse_args(argv).device
    cfg = smoke_config("minitron-4b")
    params = init_params(T.model_spec(cfg), 0, torch.float32, device=device)
    rng = np.random.default_rng(0)
    # heavy-tailed output lengths: most requests short, a few long
    reqs = [Request(uid=i, prompt=[int(rng.integers(1, cfg.vocab_size))],
                    max_new_tokens=int(rng.choice([2, 3, 3, 16])))
            for i in range(16)]

    for mode in ["bsp", "continuous"]:
        trace = []
        eng = ContinuousBatchingEngine(cfg, params, num_slots=4, max_len=64,
                                       mode=mode)
        res = eng.run(list(reqs), trace=trace)
        st = res["stats"]
        print(f"\nmode={mode}")
        print(f"  wavefronts      : {st.wavefronts}")
        print(f"  mean occupancy  : {st.mean_occupancy:.3f}")
        print(f"  active-slot trace: {trace}")
    print("\ncontinuous admits into freed slots every wavefront "
          "(relaxed barrier) -> fewer wavefronts for the same tokens.")


if __name__ == "__main__":
    main()
