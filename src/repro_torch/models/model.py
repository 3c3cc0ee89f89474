"""ModelApi: the step builders' one interface over every architecture family.

  init(generator)                      -- parameters from an explicit generator
  loss(params, batch)                  -- training objective -> (loss, metrics)
  prefill(params, batch, max_len)      -- prompt -> (logits, caches, pos)
  decode(params, caches, pos, batch)   -- one token -> (logits, caches)
  param_count(), active_param_count()
  input_specs(shape), cache_shapes(shape), supports(shape)
  layer_cache_shapes(shape)            -- cache_shapes a layer, as held
  param_pspecs(), cache_pspecs(shape)  -- partition-spec trees

Decoder-only families go through ``lm``, the encoder-decoder through
``encdec``; the ``embed`` frontend (pixtral, the enc-dec encoder) takes
precomputed embeddings in ``batch["embeds"]``. The spec trees are the
port's per-layer trees (``distributed/param_specs.py``): one spec a leaf of
``abstract_params()``, and one a leaf of ``layer_cache_shapes``: the
per-layer caches that ``lm.init_caches`` and ``encdec.prefill`` hold.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.distributed import param_specs as psp
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import TensorSpec


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


class ModelApi:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg.validate()

    # -- parameters --------------------------------------------------------

    def init(self, generator: torch.Generator):
        """Parameters on ``generator``'s device, drawn from it."""
        if self.cfg.is_encdec:
            return encdec.init_params(self.cfg, generator)
        return lm.init_params(self.cfg, generator)

    def abstract_params(self):
        """The parameter tree on the meta device: shapes and dtypes only."""
        if self.cfg.is_encdec:
            return encdec.init_params(self.cfg, None, device="meta")
        return lm.init_params(self.cfg, None, device="meta")

    def param_count(self) -> int:
        return sum(math.prod(t.shape)
                   for t in tree.leaves(self.abstract_params()))

    def active_param_count(self) -> int:
        """Parameters a token passes through: each MoE expert weight counts
        top_k / n_experts of itself (the reference's 6*N*D accounting)."""
        cfg = self.cfg
        if not (cfg.n_experts and cfg.moe_top_k):
            return self.param_count()
        total = 0
        for path, leaf in tree.leaves_with_path(self.abstract_params()):
            n = math.prod(leaf.shape)
            if "moe" in path and path[-1] in ("gate", "up", "down"):
                n = n * cfg.moe_top_k // cfg.n_experts
            total += n
        return total

    def param_pspecs(self):
        """A spec a leaf of ``abstract_params()``, in its order; a layer's
        leaf takes the reference's stacked spec without the scan entry."""
        specs = (psp.encdec_param_specs(self.cfg) if self.cfg.is_encdec
                 else psp.lm_param_specs(self.cfg))
        return _ordered_like(specs, self.abstract_params())

    # -- steps --------------------------------------------------------------

    def loss(self, params, batch):
        """(total loss, {"loss", "aux", "ntokens"}): the decoder's
        next-token loss plus the MoE aux term, or the enc-dec's mean loss."""
        if self.cfg.is_encdec:
            return encdec.loss_fn(params, self.cfg, batch)
        return lm.loss_fn(params, self.cfg, batch)

    def prefill(self, params, batch, max_len: Optional[int] = None):
        cfg = self.cfg
        if cfg.is_encdec:
            return encdec.prefill(params, cfg, batch["embeds"],
                                  batch["tokens"],
                                  max_len or batch["tokens"].shape[1])
        return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), max_len=max_len)

    def decode(self, params, caches, pos: int, batch):
        cfg = self.cfg
        if cfg.is_encdec:
            return encdec.decode_step(params, cfg, caches, pos,
                                      batch["token"])
        return lm.decode_step(params, cfg, caches, pos,
                              token=batch.get("token"),
                              embed=batch.get("embed"))

    # -- abstract inputs ----------------------------------------------------

    def input_specs(self, shape_name: str) -> Dict[str, Any]:
        """``TensorSpec`` stand-ins for every step input of this cell."""
        cfg = self.cfg
        sh = SHAPES[shape_name]
        b, s = sh.global_batch, sh.seq_len
        i32, cd = torch.int32, cfg.compute_dtype
        embeds = TensorSpec((b, s, cfg.d_model), cd)
        token = {"token": TensorSpec((b,), i32)}
        if cfg.is_encdec:
            s_dec = min(s // 4, cfg.max_target_len * 32)  # target = frames/4
            if sh.kind == "train":
                return {"embeds": embeds,
                        "tokens": TensorSpec((b, s_dec), i32),
                        "labels": TensorSpec((b, s_dec), i32)}
            if sh.kind == "prefill":
                return {"embeds": embeds,
                        "tokens": TensorSpec((b, min(s_dec, 1024)), i32)}
            return token
        if cfg.frontend == "embed":
            if sh.kind == "train":
                return {"embeds": embeds, "labels": TensorSpec((b, s), i32)}
            if sh.kind == "prefill":
                return {"embeds": embeds}
            return token
        if sh.kind == "train":
            return {"tokens": TensorSpec((b, s), i32),
                    "labels": TensorSpec((b, s), i32)}
        if sh.kind == "prefill":
            return {"tokens": TensorSpec((b, s), i32)}
        return token

    def cache_shapes(self, shape_name: str):
        cfg = self.cfg
        sh = SHAPES[shape_name]
        if cfg.is_encdec:
            # decoder self-cache capped at max_target_len; encoder memory = seq
            return encdec.cache_shapes(cfg, sh.global_batch,
                                       cfg.max_target_len, sh.seq_len)
        return lm.cache_shapes(cfg, sh.global_batch, sh.seq_len)

    def layer_cache_shapes(self, shape_name: str):
        """The serving state the port holds: a list with one tree a layer
        (decoder layer of the enc-dec), each leaf the stacked leaf of
        ``cache_shapes`` without its leading depth entry."""
        stacked = self.cache_shapes(shape_name)
        return [tree.tree_map(
            lambda s: TensorSpec(tuple(s.shape[1:]), s.dtype), stacked)
            for _ in range(self.cfg.superlayer_repeat)]

    def cache_pspecs(self, shape_name: str):
        """A spec a leaf of ``layer_cache_shapes``: the reference's spec of
        the stacked leaf, without its leading entry."""
        return psp.cache_specs(self.layer_cache_shapes(shape_name))

    def supports(self, shape_name: str) -> bool:
        sh = SHAPES[shape_name]
        return sh.name != "long_500k" or self.cfg.sub_quadratic


def _ordered_like(specs, like):
    """``specs`` with its dicts in ``like``'s key order (``tree`` zips
    leaves in order); raises where their keys differ."""
    if isinstance(like, dict):
        if set(specs) != set(like):
            raise ValueError(f"spec keys {sorted(specs)} differ from "
                             f"{sorted(like)}")
        return {k: _ordered_like(specs[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_ordered_like(s, v) for s, v in zip(specs, like, strict=True)]
    return specs
