"""LM serving over the engine's continuous-batching slot loop.

As in the JAX package's ``runtime/serve_loop.py``: the prefill/decode_step
model calls live here, and the batching loop — free slots refill FIFO,
every active request decodes one token per quantum, a slot is released on
EOS or length — is :class:`~repro_torch.engine.server.SlotLoop` verbatim.
Each decode call serves one slot at batch 1; batching the slots into one
call is later work.

Each :class:`Request` carries the host seconds its prefill and its decode
steps took (each call ends in a device sync, the ``argmax`` read back), and
``on_step(req, logits, hidden)`` sees the last-position logits and final
hidden state of every prefill and decode step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.server import QueryRequest, Server, SlotLoop
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as tf

__all__ = ["Request", "ServeEngine", "QueryRequest", "Server", "SlotLoop"]

StepHook = Callable[["Request", torch.Tensor, torch.Tensor], None]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0  # summed over the request's decode steps


class ServeEngine:
    """Single-device engine: greedy decoding, one request per decode call."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 batch_slots: int = 4, eos_id: Optional[int] = None,
                 device=None, on_step: Optional[StepHook] = None):
        tf.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.on_step = on_step

    def _prefill_request(self, req: Request):
        t0 = time.perf_counter()
        tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
        logits, caches, hidden = tf.prefill(self.params, self.cfg, {"tokens": tokens},
                                            return_hidden=True)
        caches = tf.pad_caches(self.cfg, caches, self.max_len)
        req.out_tokens.append(int(torch.argmax(logits[0])))
        req.prefill_seconds = time.perf_counter() - t0
        if self.on_step:
            self.on_step(req, logits[0], hidden[0])
        return caches, len(req.prompt)

    @torch.inference_mode()
    def submit(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Run all requests to completion with continuous batching."""
        results: Dict[int, List[int]] = {}

        def start(req: Request) -> dict:
            caches, plen = self._prefill_request(req)
            return {"caches": caches, "pos": plen}

        def step(req: Request, entry: dict) -> bool:
            t0 = time.perf_counter()
            token = torch.tensor([req.out_tokens[-1]], device=self.device)
            logits, entry["caches"], hidden = tf.decode_step(
                self.params, self.cfg, entry["caches"], token, entry["pos"],
                return_hidden=True)
            entry["pos"] += 1
            nxt = int(torch.argmax(logits[0]))
            req.out_tokens.append(nxt)
            req.decode_seconds += time.perf_counter() - t0
            if self.on_step:
                self.on_step(req, logits[0], hidden[0])
            if (len(req.out_tokens) >= req.max_new_tokens
                    or (self.eos_id is not None and nxt == self.eos_id)
                    or entry["pos"] >= self.max_len - 1):
                req.done = True
                results[req.rid] = req.out_tokens
                return True
            return False

        SlotLoop(self.batch_slots, start, step).run(requests)
        return results
