"""GPipe-style pipeline parallelism over a mesh axis, as the reference's
``distributed/pipeline.py``.

The ``pod`` axis can carry pipeline stages instead of data parallelism:
each stage owns a contiguous block of superlayers, and microbatches stream
through it. The schedule is the classic GPipe fill-drain loop:
``num_microbatches + num_stages - 1`` ticks; microbatch ``t`` enters stage
0 on tick ``t``, and the last stage emits microbatch ``t - (S - 1)``;
bubble fraction ``(S - 1) / (M + S - 1)``.

The reference runs the loop as a ``shard_map`` with ``ppermute`` moving
activations from stage to stage. The port drives every stage from one
process (ROADMAP conventions): stage ``s`` runs on the device at position
``s`` of the axis (``Mesh.axis_devices``), a device may hold several
stages, and the shift is a copy to the next stage's device (none when it
is the same). On a bubble slot the reference applies ``stage_fn`` to a
stale activation and masks the result away; the port skips the slot, so
every stage runs ``stage_fn`` exactly once a microbatch and the outputs
are the same. This is the forward pipeline (serving and evaluation).
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch import tree


def pipeline_forward(mesh, axis: str, stage_fn: Callable,
                     num_microbatches: int) -> Callable:
    """Build a pipelined forward over ``axis``.

    ``stage_fn(stage_params, x) -> x`` is applied by every stage to the
    microbatch that currently resides on it. Returns ``fn(
    stage_params_stacked, x_microbatched)``: ``stage_params_stacked`` has
    leaves (S, ...), stage ``s`` taking index ``s`` on its device;
    ``x_microbatched`` is (M, B_micro, ...). The result is (M, B_micro,
    ...), the last stage's outputs, on ``x_microbatched``'s device.
    """
    devices = mesh.axis_devices(axis)
    n_stages = len(devices)

    def run(stage_params_stacked, x_microbatched: torch.Tensor
            ) -> torch.Tensor:
        m = x_microbatched.shape[0]
        if m != num_microbatches:
            raise ValueError(f"built for {num_microbatches} microbatches, "
                             f"given {m}")
        params = [tree.tree_map(lambda a, s=s, d=d: a[s].to(d),
                                stage_params_stacked)
                  for s, d in enumerate(devices)]
        outputs: List[torch.Tensor] = [None] * m
        state: List[torch.Tensor] = [None] * n_stages   # input of each stage
        for t in range(m + n_stages - 1):
            if t < m:
                state[0] = x_microbatched[t].to(devices[0])
            nxt: List[torch.Tensor] = [None] * n_stages
            for s in range(n_stages):
                if not 0 <= t - s < m:          # a bubble slot
                    continue
                y = stage_fn(params[s], state[s])
                if s == n_stages - 1:
                    outputs[t - s] = y
                else:
                    nxt[s + 1] = y.to(devices[s + 1])
            state[1:] = nxt[1:]
        return torch.stack([y.to(x_microbatched.device) for y in outputs])

    return run


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
