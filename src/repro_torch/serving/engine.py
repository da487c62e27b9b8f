"""Atos continuous-batching serving engine.

The counterpart of ``repro/serving/engine.py``: the paper's scheduler
carried into LLM serving.  Requests are tasks and decode slots are
workers.  ``mode='bsp'`` admits a batch and decodes until every sequence
in it finishes before admitting the next (the barrier baseline);
``mode='continuous'`` refills freed slots from the queue every wavefront,
so requests at different depths share a wavefront (the cache carries a
per-slot length).

The decode wavefront always runs all S slots; inactive slots are masked
so that their caches do not advance (``blend_cache``).  The engine's
outputs equal one-request-at-a-time greedy decoding (``decode_single``).
The cache is replaced, not written in place: ``decode_step`` returns new
kv and ssm tensors and ``blend_cache`` selects between old and new rows.
Every model family serves through the same engine.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.tree import tree_map
from ..models import transformer as T


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list        # token ids
    max_new_tokens: int


@dataclasses.dataclass
class EngineStats:
    wavefronts: int = 0
    slot_occupancy_sum: float = 0.0
    completed: int = 0

    @property
    def mean_occupancy(self):
        return self.slot_occupancy_sum / max(self.wavefronts, 1)


def blend_cache(old: T.DecodeCache, new: T.DecodeCache, mask: torch.Tensor
                ) -> T.DecodeCache:
    """Keep ``new`` only for rows where mask is True.

    kv and ssm leaves carry the batch at dim 1 ([L, B, ...]); length at
    dim 0.  The encoder's K and V are read-only during decode.
    """
    def blend(o, n):
        return torch.where(mask.reshape(1, -1, *([1] * (o.dim() - 2))), n, o)

    return T.DecodeCache(kv=tree_map(blend, old.kv, new.kv),
                         ssm=tree_map(blend, old.ssm, new.ssm), enc=old.enc,
                         length=torch.where(mask, new.length, old.length))


def reset_slot(cache: T.DecodeCache, s: int) -> T.DecodeCache:
    """Clear one slot's rows before admitting a new request into it."""
    def cleared(a):
        a = a.clone()
        a[:, s] = 0
        return a

    length = cache.length.clone()
    length[s] = 0
    return T.DecodeCache(kv=tree_map(cleared, cache.kv),
                         ssm=tree_map(cleared, cache.ssm), enc=cache.enc,
                         length=length)


class ContinuousBatchingEngine:
    """mode='continuous' (Atos) or 'bsp' (barrier baseline).  Runs where
    ``params`` live."""

    def __init__(self, cfg, params, num_slots: int, max_len: int,
                 mode: str = "continuous", dtype=torch.float32):
        if mode not in ("continuous", "bsp"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg, self.params = cfg, params
        self.num_slots, self.mode = num_slots, mode
        self.max_len = max_len
        self.dtype = dtype
        self.device = params["embed"]["tok"].device

    def _step(self, cache, tokens: np.ndarray, mask: np.ndarray):
        logits, new_cache = T.decode_step(
            self.params, self.cfg, cache,
            torch.as_tensor(tokens, device=self.device))
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, blend_cache(cache, new_cache,
                                     torch.as_tensor(mask, device=self.device))

    def fresh_cache(self):
        return T.init_cache(self.cfg, self.num_slots, self.max_len,
                            self.dtype, device=self.device)

    def run(self, requests: List[Request],
            trace: Optional[list] = None) -> dict:
        """Serve ``requests``; ``trace``, if given, receives each
        wavefront's count of active slots."""
        S = self.num_slots
        pending = list(requests)
        active: dict[int, Request] = {}
        outputs: dict[int, list] = {r.uid: [] for r in requests}
        cache = self.fresh_cache()
        slot_tok = np.zeros((S, 1), np.int32)
        slot_remaining = np.zeros(S, np.int64)
        stats = EngineStats()

        def admit():
            nonlocal cache
            for s in range(S):
                if s not in active and pending:
                    r = pending.pop(0)
                    active[s] = r
                    cache = reset_slot(cache, s)
                    # prefill the slot by replaying the prompt with only this
                    # slot unmasked, as the reference does
                    mask = np.zeros(S, bool)
                    mask[s] = True
                    for t in r.prompt[:-1]:
                        tok = slot_tok.copy()
                        tok[s, 0] = t
                        _, cache = self._step(cache, tok, mask)
                    slot_tok[s, 0] = r.prompt[-1]
                    slot_remaining[s] = r.max_new_tokens

        while pending or active:
            if self.mode == "continuous" or not active:
                admit()
            mask = np.zeros(S, bool)
            for s in active:
                mask[s] = True
            next_tok, cache = self._step(cache, slot_tok, mask)
            next_np = next_tok.cpu().numpy()
            stats.wavefronts += 1
            stats.slot_occupancy_sum += len(active) / S
            if trace is not None:
                trace.append(len(active))
            for s in list(active):
                outputs[active[s].uid].append(int(next_np[s, 0]))
                slot_tok[s, 0] = int(next_np[s, 0])
                slot_remaining[s] -= 1
                if slot_remaining[s] <= 0:
                    del active[s]
                    stats.completed += 1
        return {"outputs": outputs, "stats": stats}


def decode_single(cfg, params, prompt: list, max_new_tokens: int,
                  max_len: int, dtype=torch.float32) -> list:
    """Oracle: one-request greedy decode (the engine must match this)."""
    device = params["embed"]["tok"].device
    cache = T.init_cache(cfg, 1, max_len, dtype, device=device)

    def step(t):
        return T.decode_step(params, cfg, cache,
                             torch.tensor([[int(t)]], dtype=torch.int32,
                                          device=device))

    for t in prompt:
        logits, cache = step(t)
    out = []
    tok = int(torch.argmax(logits[0]))
    for _ in range(max_new_tokens):
        out.append(tok)
        logits, cache = step(tok)
        tok = int(torch.argmax(logits[0]))
    return out
