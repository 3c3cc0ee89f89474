"""Step builders: prefill and decode (the train step waits for ROADMAP
item 17). PyTorch runs eagerly, so a step is the ModelApi call itself."""
from __future__ import annotations

from typing import Callable

from repro_torch.models.model import ModelApi


def build_prefill_step(api: ModelApi) -> Callable:
    def prefill_step(params, batch):
        return api.prefill(params, batch)

    return prefill_step


def build_decode_step(api: ModelApi) -> Callable:
    def decode_step(params, caches, pos, batch):
        return api.decode(params, caches, pos, batch)

    return decode_step
