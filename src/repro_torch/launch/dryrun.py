"""Multi-pod dry run on the ``meta`` device: every (arch x shape x mesh)
cell's FLOPs and bytes per device, in the record the reference's
``launch/dryrun.py`` writes.

The reference lowers and compiles each cell's step for 512 fake XLA
devices and records ``memory_analysis()``, ``cost_analysis()`` and the
collective schedule parsed from the partitioned HLO. PyTorch has no
compiler to ask, so this module is the substitute for those three
(ROADMAP item 18c). Every tensor lives on ``meta`` (shapes and dtypes
only): no card, no JAX and no memory is needed, a cell takes seconds.

- ``cost.flops_global``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the step, 2 M N K for every matrix product, batched product, convolution
  and attention product of the whole (unpartitioned) step. A ``meta``
  tensor follows the reference's branches of the model code, the plain
  attention included (``kernels/__init__.py``), so the count is the
  reference's product count (``tests/test_torch_dryrun.py`` holds it to
  the ``dot_general`` products of ``jax.make_jaxpr``). XLA's
  ``cost_analysis`` also counts elementwise operations, which this does
  not. The count is taken on ``meta`` only: on a CUDA tensor the attention
  is a ``ctypes`` launch that ``FlopCounterMode`` cannot see.
- ``cost.flops``: ``flops_global / devices``, an even split. The
  reference's number is per device after XLA's SPMD partitioning; the port
  has no partitioner.
- ``memory.argument_bytes``: the sum of ``partition.device_bytes`` (one
  mesh position's bytes under the sanitized specs) over the step's
  arguments: parameters, optimizer state (train), the batch
  (``param_specs.batch_specs``), caches and ``pos`` (decode);
  ``argument_parts`` holds each part.
- ``cost.bytes``, ``memory.output_bytes``, ``temp_bytes``, ``alias_bytes``,
  ``peak_estimate_bytes``, ``collectives`` and ``compile_s`` have no
  counterpart: each is ``None``, and ``substitute`` says why.

The split is the reference's: XLA counts a scan body once, so ``full`` is
the step with the config cut to one superlayer (and one encoder layer)
over one microbatch of ``global_batch / accum`` rows; the probes
(``launch/probes.py``) count one superlayer; ``scale_totals`` adds
``(repeats - 1)`` probes and multiplies by ``accum`` for training.
Counts are memoised in the process by (config, shape, model axis, part,
rows): the two meshes share them.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k [--multi-pod] [--skip-probes] [--out experiments/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.distributed import param_specs as psp
from repro_torch.distributed.partition import (P, device_bytes, make_rules,
                                               use_rules)
from repro_torch.launch import probes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                      build_train_step, default_optimizer)
from repro_torch.models.kvcache import TensorSpec
from repro_torch.models.layers import rope_frequencies
from repro_torch.models.model import SHAPES, ModelApi

META = torch.device("meta")
SKIP_REASON = ("full-attention architecture: 500k dense decode out of scope "
               "(DESIGN.md §3)")
_XLA_MEMORY = "null, no counterpart: XLA's memory_analysis of the program"
# what each field of the record is here, beside the reference's
SUBSTITUTE = {
    "cost.flops_global": "FlopCounterMode over the step on meta tensors: "
                         "2 M N K of every matrix, batched, convolution and "
                         "attention product of the unpartitioned step; XLA's "
                         "cost_analysis also counts elementwise operations",
    "cost.flops": "even split, cost.flops_global / devices: the reference's "
                  "is per device after XLA's SPMD partitioning, which the "
                  "port does not have",
    "cost.bytes": "null, no counterpart: XLA's bytes accessed of the "
                  "compiled program",
    "memory.argument_bytes": "sum of partition.device_bytes over the step's "
                             "arguments under the sanitized specs "
                             "(argument_parts)",
    "memory.output_bytes": _XLA_MEMORY,
    "memory.temp_bytes": _XLA_MEMORY,
    "memory.alias_bytes": _XLA_MEMORY,
    "memory.peak_estimate_bytes": _XLA_MEMORY,
    "collectives": "null, no counterpart: parsed from XLA's partitioned HLO; "
                   "the port runs no SPMD partitioner",
    "compile_s": "null, no counterpart: nothing is compiled; count_s is the "
                 "count's wall time",
}

_FLOPS: Dict[Tuple, int] = {}


def input_specs(arch: str, shape: str = "train_4k") -> Dict[str, TensorSpec]:
    """``TensorSpec`` stand-ins for every model input of this cell."""
    return ModelApi(get_config(arch)).input_specs(shape)


def _meta(spec) -> torch.Tensor:
    return torch.empty(tuple(spec.shape), dtype=spec.dtype, device=META)


def _rows(specs: Dict[str, TensorSpec], rows: int) -> Dict[str, TensorSpec]:
    """``specs`` with their leading (batch) dimension set to ``rows``."""
    return {k: TensorSpec((rows,) + tuple(v.shape[1:]), v.dtype)
            for k, v in specs.items()}


def _bytes(leaves_tree, spec_tree, mesh) -> int:
    return device_bytes(tree.leaves(leaves_tree), tree.leaves(spec_tree),
                        mesh)


def _count(key: Tuple, fn: Callable[[], Any]) -> Dict[str, Any]:
    """``fn()``'s products counted by ``FlopCounterMode`` (memoised by
    ``key``), with the wall seconds of this call."""
    t0 = time.perf_counter()
    if key not in _FLOPS:
        with FlopCounterMode(display=False) as counter:
            fn()
        _FLOPS[key] = int(counter.get_total_flops())
    return {"flops_global": _FLOPS[key],
            "count_s": time.perf_counter() - t0}


def _cost(counted: Dict[str, Any], devices: int) -> Dict[str, Any]:
    return {"cost": {"flops": counted["flops_global"] / devices,
                     "flops_global": counted["flops_global"],
                     "bytes": None},
            "collectives": None, "compile_s": None,
            "count_s": counted["count_s"]}


def _cut(cfg):
    """``cfg`` with one superlayer (and one encoder layer): the step whose
    count is XLA's count of it (a scan body once)."""
    return dataclasses.replace(
        cfg, superlayer_repeat=1, n_layers=len(cfg.block_pattern),
        n_enc_layers=1 if cfg.is_encdec else cfg.n_enc_layers)


def _rope(cfg, length: int):
    return rope_frequencies(cfg.resolved_head_dim, length, cfg.rope_theta,
                            META)


def cell_fields(arch: str, shape: str, multi_pod: bool,
                overrides: Optional[Dict[str, Any]] = None
                ) -> Tuple[Dict[str, Any], Any]:
    """(the cell's fields, as the reference's record has them, and its
    ``ModelApi``): no count is taken. A supported cell also has
    ``seq_shard``, ``ws_decode``, ``decode_loop``, ``devices`` and the
    clamped ``grad_accum``."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    api = ModelApi(cfg)
    sh = SHAPES[shape]
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "kind": sh.kind, "seq_len": sh.seq_len,
        "global_batch": sh.global_batch,
        "param_count": api.param_count(),
        "active_param_count": api.active_param_count(),
        "superlayer_repeat": cfg.superlayer_repeat,
        "blocks_per_superlayer": len(cfg.block_pattern),
        "grad_accum": cfg.grad_accum if sh.kind == "train" else 1,
        "n_enc_layers": cfg.n_enc_layers,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    if not api.supports(shape):
        result["status"] = "skipped"
        result["skip_reason"] = SKIP_REASON
        return result, api
    mesh = make_production_mesh(multi_pod=multi_pod)
    result["seq_shard"] = (cfg.seq_shard_activations
                           and sh.kind in ("train", "prefill"))
    result["ws_decode"] = (cfg.weight_stationary_decode
                           and sh.kind == "decode")
    result["decode_loop"] = cfg.decode_loop
    result["devices"] = mesh.size
    if sh.kind == "train":
        # microbatches must still cover every DP replica
        dp = mesh.size // mesh.shape.get("model", 1)
        result["grad_accum"] = max(1, min(cfg.grad_accum,
                                          sh.global_batch // dp))
    return result, api


def run_cell(arch: str, shape: str, multi_pod: bool,
             skip_probes: bool = False,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    result, api = cell_fields(arch, shape, multi_pod, overrides)
    if result.get("status") == "skipped":
        return result
    cfg, sh = api.cfg, SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(mesh, seq_shard=result["seq_shard"],
                       ws_decode=result["ws_decode"])
    n_dev = mesh.size
    memo = (cfg, sh, rules.model_size)
    cut = ModelApi(_cut(cfg))

    parts = argument_parts(api, shape, mesh)
    with use_rules(rules):
        params_abs = api.abstract_params()
        cut_params = cut.abstract_params()
        if sh.kind == "train":
            rows = sh.global_batch // result["grad_accum"]
            optimizer = default_optimizer(cfg)
            step = build_train_step(cut, optimizer, accum=1)
            micro = {k: _meta(v)
                     for k, v in _rows(cut.input_specs(shape), rows).items()}
            full = _count(memo + ("full", rows), lambda: step(
                cut_params, optimizer.init(cut_params), micro))
            if not skip_probes:
                result["probe"] = _train_probe(api, params_abs, sh, rows,
                                               memo + ("probe", rows),
                                               n_dev)
        elif sh.kind == "prefill":
            step = build_prefill_step(cut)
            batch = {k: _meta(v) for k, v in api.input_specs(shape).items()}
            full = _count(memo + ("full",), lambda: step(cut_params, batch))
            if not skip_probes:
                result["probe"] = _prefill_probe(api, params_abs, sh,
                                                 memo + ("probe",), n_dev)
        else:  # decode
            caches_abs = api.layer_cache_shapes(shape)
            step = build_decode_step(cut)
            caches = [tree.tree_map(_meta, c)
                      for c in cut.layer_cache_shapes(shape)]
            batch = {k: _meta(v) for k, v in api.input_specs(shape).items()}
            pos = _decode_pos(cfg, caches_abs[0])
            full = _count(memo + ("full",),
                          lambda: step(cut_params, caches, pos, batch))
            if not skip_probes:
                result["probe"] = _decode_probe(api, params_abs, caches_abs,
                                                sh, pos, memo + ("probe",),
                                                n_dev)

    result["full"] = _cost(full, n_dev)
    result["full"]["memory"] = {
        "argument_bytes": float(sum(parts.values())),
        "output_bytes": None, "temp_bytes": None, "alias_bytes": None,
        "peak_estimate_bytes": None}
    result["argument_parts"] = parts
    result["substitute"] = SUBSTITUTE
    result["status"] = "ok"
    result["totals"] = scale_totals(result)
    return result


def argument_parts(api: ModelApi, shape: str, mesh) -> Dict[str, int]:
    """One mesh position's bytes of each of the step's arguments under the
    sanitized specs: ``params``, ``batch``, ``optimizer_state`` (train),
    ``caches`` and ``pos`` (decode)."""
    kind = SHAPES[shape].kind
    params, specs = api.abstract_params(), api.param_pspecs()
    batch = api.input_specs(shape)
    parts = {"params": _bytes(params, specs, mesh),
             "batch": _bytes(batch, psp.batch_specs(batch), mesh)}
    if kind == "train":
        optimizer = default_optimizer(api.cfg)
        parts["optimizer_state"] = _bytes(optimizer.init(params),
                                          optimizer.state_pspecs(specs), mesh)
    elif kind == "decode":
        parts["caches"] = _bytes(api.layer_cache_shapes(shape),
                                 api.cache_pspecs(shape), mesh)
        parts["pos"] = _bytes(TensorSpec((), torch.int32), P(), mesh)
    return parts


def _decode_pos(cfg, cache: Dict[str, Any]) -> int:
    """The write position of the counted decode step: the last entry of
    the self-attention cache (the count does not depend on it)."""
    if cfg.is_encdec:
        return cache["k"].shape[2] - 1
    for blk in cache.values():
        if "k" in blk:
            return blk["k"].shape[2] - 1
    return 0


def _train_probe(api, params_abs, sh, rows: int, key: Tuple, n_dev: int):
    """Grad through one superlayer (or one encoder and one decoder layer)
    on one microbatch."""
    cfg = api.cfg
    cd = cfg.compute_dtype
    if cfg.is_encdec:
        enc_probe, dec_probe = probes.encdec_train_bodies(api)
        s_dec = min(sh.seq_len // 4, cfg.max_target_len * 32)
        enc_out = _meta(TensorSpec((rows, sh.seq_len, cfg.d_model), cd))
        out = {}
        for name, layers, s_len, fn in (
                ("enc", "enc_layers", sh.seq_len, enc_probe),
                ("dec", "dec_layers", s_dec, dec_probe)):
            x = _meta(TensorSpec((rows, s_len, cfg.d_model), cd))
            cos, sin = _rope(cfg, s_len)
            extra = (enc_out,) if name == "dec" else ()
            out[name] = _cost(_count(key + (name,), lambda: fn(
                params_abs[layers][0], x, *extra, cos, sin)), n_dev)
        return out
    x = _meta(TensorSpec((rows, sh.seq_len, cfg.d_model), cd))
    cos, sin = _rope(cfg, sh.seq_len)
    probe = probes.train_body_fn(api)
    return _cost(_count(key, lambda: probe(
        params_abs["layers"][0], params_abs.get("shared"), x, cos, sin)),
        n_dev)


def _prefill_probe(api, params_abs, sh, key: Tuple, n_dev: int):
    cfg = api.cfg
    cd, b = cfg.compute_dtype, sh.global_batch
    if cfg.is_encdec:
        enc_probe, dec_probe = probes.encdec_prefill_bodies(api)
        enc_out = _meta(TensorSpec((b, sh.seq_len, cfg.d_model), cd))
        out = {}
        for name, layers, s_len, fn in (
                ("enc", "enc_layers", sh.seq_len, enc_probe),
                ("dec", "dec_layers", min(sh.seq_len // 4, 1024),
                 dec_probe)):
            x = _meta(TensorSpec((b, s_len, cfg.d_model), cd))
            cos, sin = _rope(cfg, s_len)
            extra = (enc_out,) if name == "dec" else ()
            out[name] = _cost(_count(key + (name,), lambda: fn(
                params_abs[layers][0], x, *extra, cos, sin)), n_dev)
        return out
    probe = probes.prefill_body_fn(api, max_len=sh.seq_len)
    x = _meta(TensorSpec((b, sh.seq_len, cfg.d_model), cd))
    cos, sin = _rope(cfg, sh.seq_len)
    return _cost(_count(key, lambda: probe(
        params_abs["layers"][0], params_abs.get("shared"), x, cos, sin)),
        n_dev)


def _decode_probe(api, params_abs, caches_abs, sh, pos: int, key: Tuple,
                  n_dev: int):
    cfg = api.cfg
    b = sh.global_batch
    cache = tree.tree_map(_meta, caches_abs[0])
    x = _meta(TensorSpec((b, cfg.d_model), cfg.compute_dtype))
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=META)
    if cfg.is_encdec:
        probe = probes.encdec_dec_decode_body(api)
        enc_len = torch.full((b,), cache["ck"].shape[2], dtype=torch.int32,
                             device=META)
        cos, sin = _rope(cfg, cache["k"].shape[2])
        return _cost(_count(key, lambda: probe(
            params_abs["dec_layers"][0], x, cache, pos, kv_len, enc_len, cos,
            sin)), n_dev)
    probe = probes.decode_body_fn(api)
    cos, sin = _rope(cfg, sh.seq_len)
    return _cost(_count(key, lambda: probe(
        params_abs["layers"][0], params_abs.get("shared"), x, cache, cos,
        sin, pos, kv_len)), n_dev)


def _plus(a, b, scale):
    return None if a is None or b is None else a + scale * b


def scale_totals(result: Dict[str, Any]) -> Dict[str, Any]:
    """full + (repeats-1) x probe, x accum for training (DESIGN.md §5); a
    quantity without a counterpart stays ``None``."""
    full = result["full"]
    kind = result["kind"]
    repeat = result["superlayer_repeat"]
    accum = result.get("grad_accum", 1)
    probe = result.get("probe")

    def add(a, b, scale):
        return {k: _plus(a[k], b[k], scale)
                for k in ("flops", "flops_global", "bytes")}

    def coll_bytes(info):
        c = info["collectives"]
        return None if c is None else float(c["total_bytes"])

    totals = dict(full["cost"])
    coll = coll_bytes(full)
    train = kind == "train"
    if probe is not None and "cost" in probe:          # decoder-only (any kind)
        totals = add(totals, probe["cost"], repeat - 1)
        coll = _plus(coll, coll_bytes(probe), repeat - 1)
    elif probe is not None:                             # enc-dec (train/prefill)
        n_enc = result.get("n_enc_layers", 0)
        totals = add(totals, probe["enc"]["cost"], max(0, n_enc - 1))
        totals = add(totals, probe["dec"]["cost"], repeat - 1)
        coll = _plus(_plus(coll, coll_bytes(probe["enc"]), max(0, n_enc - 1)),
                     coll_bytes(probe["dec"]), repeat - 1)
    if train:
        totals = {k: None if v is None else v * accum
                  for k, v in totals.items()}
        coll = None if coll is None else coll * accum
    totals["collective_bytes"] = coll
    return totals


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   skip_probes=args.skip_probes)
    name = f"{args.arch}__{args.shape}__{res['mesh']}.json"
    path = os.path.join(args.out, name)
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    if res["status"] == "ok":
        mem = res["full"]["memory"]
        print(f"{args.arch} x {args.shape} x {res['mesh']}: OK  "
              f"args/dev={mem['argument_bytes'] / 2**30:.2f} GiB  "
              f"flops/dev={res['totals']['flops']:.3e} (even split of "
              f"{res['totals']['flops_global']:.3e})  "
              f"count={res['full']['count_s']:.1f}s")
        print("argument bytes by part:", {k: round(v / 2**20, 1) for k, v
                                          in res["argument_parts"].items()},
              "MiB")
        print("cost:", res["full"]["cost"])
    else:
        print(f"{args.arch} x {args.shape}: SKIPPED ({res['skip_reason']})")


if __name__ == "__main__":
    main()
