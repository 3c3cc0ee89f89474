"""The enrichment stage of a scored deployment, built from its
configuration's ``enrichment`` block.

The block names

- ``arch``: the scorer's architecture id in ``repro_torch.configs``;
- ``model``: the architecture's plain settings as published, which the
  plain scorer reads (the reference imports nothing of the program);
- ``overrides``: the cut to one chip, applied to both; each key is also in
  the configuration's ``reduced``;
- ``budget`` and ``lanes``: pairs kept a channel an execution, and the head
  columns a score averages;
- ``plain``: the module of ``bad_bench/reference/scorers/`` that draws the
  weights and scores them plainly;
- ``tolerance``: ``atol``, ``rtol`` and ``why`` of a score.

``stage`` draws the weights once from the seed with the plain module's
``init`` (a ``torch.Generator`` on the device, one call a stacked leaf),
hands them to the program in its own per-layer tree and types, and returns
its ``LMScorer``. The reference draws its own from the same seed after the
window.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch


def plain(block: Dict):
    return importlib.import_module(
        f"bad_bench.reference.scorers.{block['plain']}")


def model_settings(block: Dict) -> Dict:
    """The plain settings with the cut applied."""
    return {**block["model"], **block.get("overrides", {})}


def _same(a, b) -> bool:
    """Two settings equal: numbers by value, types by name."""
    num = (int, float)
    if isinstance(a, num) and isinstance(b, num) and \
            not isinstance(a, bool) and not isinstance(b, bool):
        return float(a) == float(b)
    return str(a).replace("torch.", "") == str(b).replace("torch.", "")


def program_config(block: Dict):
    """The program's ``ModelConfig`` of the block: the registry's entry with
    the overrides applied. Raises where it disagrees with the plain
    settings on a key both have."""
    from repro_torch import configs
    cfg = configs.get_config(block["arch"])
    over = {k: getattr(torch, v) if k.endswith("_dtype") else v
            for k, v in block.get("overrides", {}).items()}
    cfg = dataclasses.replace(cfg, **over).validate()
    wrong = {k: (v, getattr(cfg, k))
             for k, v in model_settings(block).items()
             if hasattr(cfg, k) and not _same(v, getattr(cfg, k))}
    if wrong:
        raise ValueError(f"enrichment {block['arch']}: the plain settings "
                         f"and the program's disagree (plain, program): "
                         f"{wrong}")
    return cfg


def port_params(cfg, tree: Dict, dev) -> Dict:
    """The stacked plain tree as the program's parameters: ``layers``
    split into one tree per superlayer (``interop.params_from_numpy``'s
    rule, for tensors already on the device), every leaf in the type the
    program's own ``init`` gives it (its ``abstract_params``), shapes
    checked. Entries are taken out of ``tree`` as they are carried, so the
    float32 copy is freed an entry at a time."""
    from repro_torch.models.model import ModelApi
    want = ModelApi(cfg).abstract_params()

    def carry(src, ref, path):
        if isinstance(ref, dict):
            if set(src) != set(ref):
                raise ValueError(f"{path}: plain leaves {sorted(src)}, "
                                 f"program's {sorted(ref)}")
            return {k: carry(src.pop(k), ref[k], f"{path}/{k}")
                    for k in list(ref)}
        if tuple(src.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: plain {tuple(src.shape)}, program "
                             f"{tuple(ref.shape)}")
        return src.to(device=dev, dtype=ref.dtype)

    out = {}
    for key in list(want):
        node = tree.pop(key)
        if key == "layers":           # the superlayers, stacked on axis 0
            out[key] = [carry(_slice(node, i), want[key][i], f"{key}[{i}]")
                        for i in range(cfg.superlayer_repeat)]
        else:
            out[key] = carry(node, want[key], key)
    if tree:
        raise ValueError(f"plain leaves the program lacks: {sorted(tree)}")
    return out


def _slice(node, i: int):
    if isinstance(node, dict):
        return {k: _slice(v, i) for k, v in node.items()}
    return node[i]


def stage(block: Dict, seed: int, dev):
    """The program's ``LMScorer`` on the weights drawn from ``seed``."""
    from repro_torch.core.enrich import LMScorer
    cfg = program_config(block)
    weights = plain(block).init(model_settings(block), seed, dev)
    params = port_params(cfg, weights.pop("tree"), dev)
    return LMScorer(cfg, params=params, budget=int(block["budget"]),
                    seed=seed, lanes=int(block["lanes"]), device=dev)
