"""Batched serving engine: prefill + decode over waves of ``batch_slots``
requests, as the JAX package's ``repro.serve.engine``.

Greedy decoding (argmax) keeps the engine deterministic; the sampling hook
takes logits [B,V] and returns token ids [B]. The engine runs on its
model API's device (``get_model``'s, the CUDA card unless the caller asked
for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.models.registry import ModelApi


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, api: ModelApi, max_len: int = 256,
                 batch_slots: int = 4, eos_id: int | None = None,
                 sampler: Callable | None = None):
        self.api = api
        self.device = api.device
        self.max_len = max_len
        self.slots = batch_slots
        self.eos = eos_id
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self._params = None

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve all requests, ``batch_slots`` at a time (one prompt length
        per wave: the batched prefill does not pad)."""
        if self._params is None:
            raise RuntimeError("ServeEngine.run before load()")
        queue = list(requests)
        while queue:
            wave = queue[: self.slots]
            queue = queue[self.slots:]
            self._run_wave(wave)
        return requests

    def _run_wave(self, wave: list[Request]) -> None:
        B = len(wave)
        S = len(wave[0].prompt)
        if any(len(r.prompt) != S for r in wave):
            raise ValueError("a wave's prompts must share one length")
        tokens = torch.as_tensor(np.stack([r.prompt for r in wave]),
                                 dtype=torch.long, device=self.device)
        logits, cache = self.api.prefill(self._params, {"tokens": tokens},
                                         self.max_len)
        pos = S
        next_tok = self.sampler(logits[:, -1])
        for i, t in enumerate(next_tok.tolist()):
            wave[i].out.append(int(t))
        active = np.ones(B, bool)
        max_new = max(r.max_new_tokens for r in wave)
        for _ in range(1, max_new):
            logits, cache = self.api.decode(self._params, cache,
                                            next_tok[:, None], pos)
            pos += 1
            next_tok = self.sampler(logits[:, -1])
            for i, t in enumerate(next_tok.tolist()):
                r = wave[i]
                if not active[i]:
                    continue
                if len(r.out) >= r.max_new_tokens:
                    active[i] = False
                    r.done = True
                    continue
                r.out.append(int(t))
                if self.eos is not None and t == self.eos:
                    active[i] = False
                    r.done = True
            if not active.any():
                break
        for r in wave:
            r.done = True

    def load(self, params) -> None:
        """Serve ``params`` (an ``LM`` on the API's device)."""
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {self.device}")
        self._params = params
