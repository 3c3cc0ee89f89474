"""ModelApi: the step builders' one interface over a model, dense LM only.

  init(generator)                      -- parameters from an explicit generator
  prefill(params, batch, max_len)      -- prompt -> (logits, caches, pos)
  decode(params, caches, pos, batch)   -- one token -> (logits, caches)
  param_count()

Enc-dec models and the ``embed`` frontend raise ``NotImplementedError``
(ROADMAP Queue 1, item 17), as do ``loss`` (training, item 17) and the
partition specs (the mesh, item 18).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, not_ported


class ModelApi:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg.validate()
        if cfg.is_encdec:
            raise not_ported("the encoder-decoder ModelApi")
        if cfg.frontend != "token":
            raise not_ported(f"the {cfg.frontend!r} frontend")

    def init(self, generator: torch.Generator):
        """Parameters on ``generator``'s device, drawn from it."""
        return lm.init_params(self.cfg, generator)

    def param_count(self) -> int:
        tree = lm.init_params(self.cfg, None, device="meta")
        leaves = [tree["embed"], tree["final_norm"], tree.get("head")]
        stack = list(tree["layers"])
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                leaves.append(node)
        return sum(math.prod(t.shape) for t in leaves if t is not None)

    def loss(self, params, batch):
        raise not_ported("training (ModelApi.loss)")

    def param_pspecs(self):
        raise not_ported("partition specs", "item 18")

    def prefill(self, params, batch, max_len: Optional[int] = None):
        return lm.prefill(params, self.cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), max_len=max_len)

    def decode(self, params, caches, pos: int, batch):
        return lm.decode_step(params, self.cfg, caches, pos,
                              token=batch.get("token"),
                              embed=batch.get("embed"))
