"""Post-join enrichment: a model-scored delivery budget per channel.

An ``EnrichmentStage`` plugs into the fused tick after each plan-group's
join and before ``broker.deliver_all``: it scores every candidate record of
the stacked result in ONE batched call, and the lowest-scored pairs past a
per-channel budget are dropped (counted in ``DeliveryStats.ranked_*``). The
contract is the reference's (``repro/core/enrich.py``):

  * one score per (channel, candidate-row) slot; every pair of a slot
    inherits it. ``payload_tokens`` is the record's field vector,
    ``channel_ids`` the global channel rows, ``sids`` the record row ids.
  * a channel whose produced pairs fit its budget passes through bit for
    bit, so an under-budget stage leaves delivery unchanged.
  * an over-budget channel keeps the top ``budget`` pairs by (score desc,
    ravel position asc) and delivers them in ravel order; the rest count
    in ``ranked_pairs`` / ``ranked_sids``, a subset of ``dropped_*``.
  * a stage's ``identity`` is stamped into every dispatched
    ``ChannelPlan.scorer``, so stream buckets and retry rings key on it.

``LMScorer`` runs the dense LM of ``repro_torch.models`` (one batched
prefill per scored group); on the card its attention is the hand-written
``flash_attention`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import records as R
from repro_torch.core.broker import _member_counts
from repro_torch.core.plans import ChannelResult
from repro_torch.device import DeviceLike, resolve_device

I32 = torch.int32


@runtime_checkable
class EnrichmentStage(Protocol):
    """A batched post-join scorer with a per-channel delivery budget.

    ``budget`` caps delivered pairs per channel per execution (None: no
    pruning, and no scoring). ``identity`` is hashable and changes whenever
    the scoring changes: it keys the engine's plan-keyed state."""

    @property
    def budget(self) -> Optional[int]: ...

    @property
    def identity(self) -> tuple: ...

    def score(self, payload_tokens: torch.Tensor, channel_ids: torch.Tensor,
              sids: torch.Tensor) -> torch.Tensor:
        """(N, F) int32 payload tokens, (N,) channel rows, (N,) record ids
        -> (N,) float32 scores on the tokens' device."""
        ...


@dataclasses.dataclass(frozen=True)
class NoopScorer:
    """Constant scores: the kept set is the ravel-order prefix, so an
    under-budget NoopScorer engine equals a scorer-less one."""

    budget: Optional[int] = None

    @property
    def identity(self) -> tuple:
        return ("noop", self.budget)

    def score(self, payload_tokens, channel_ids, sids):
        return torch.zeros(payload_tokens.shape[:1], dtype=torch.float32,
                           device=payload_tokens.device)


@dataclasses.dataclass(frozen=True)
class HeuristicScorer:
    """A fixed urgency weighting of the enriched fields: threat and
    hate-speech rates dominate, weapon / drug flags and retweet reach break
    ties."""

    budget: Optional[int] = None
    weights: Tuple[float, ...] = (3.0, 2.0, 1.0, 0.5, 1e-3)

    @property
    def identity(self) -> tuple:
        return ("heuristic", self.budget, self.weights)

    def score(self, payload_tokens, channel_ids, sids):
        f = payload_tokens.float()
        w = self.weights
        return (w[0] * f[:, R.THREATENING_RATE]
                + w[1] * f[:, R.HATE_SPEECH_RATE]
                + w[2] * f[:, R.WEAPON_MENTIONED]
                + w[3] * f[:, R.DRUG_ACTIVITY]
                + w[4] * f[:, R.RETWEET_COUNT])


class LMScorer:
    """LM scorer: one batched prefill (``launch/serve.prefill_scores``) over
    the candidates' payload tokens. The record's field vector is the prompt
    (clipped into the vocab); the mean of the first ``lanes`` final-position
    logits is the score. Parameters are drawn once, from a
    ``torch.Generator`` seeded ``seed`` on ``device``, unless given (the
    tests carry the reference's across with ``interop.params_from_numpy``);
    the stage is frozen, so ``identity`` needs only the config name, seed,
    lanes and budget. The default config is reduced qwen2-1.5b, as in the
    reference."""

    def __init__(self, cfg=None, params=None, budget: Optional[int] = None,
                 seed: int = 0, lanes: int = 64, device: DeviceLike = "cuda"):
        from repro_torch import configs
        from repro_torch.models.model import ModelApi
        self.cfg = cfg if cfg is not None else configs.get_reduced("qwen2-1.5b")
        self.api = ModelApi(self.cfg)
        dev = resolve_device(device)
        self.params = (params if params is not None else self.api.init(
            torch.Generator(dev).manual_seed(seed)))
        self.budget = budget
        self.seed = seed
        self.lanes = lanes

    @property
    def identity(self) -> tuple:
        return ("lm", self.cfg.name, self.seed, self.lanes, self.budget)

    def score(self, payload_tokens, channel_ids, sids):
        from repro_torch.launch.serve import prefill_scores
        toks = torch.clamp(payload_tokens, 0, self.cfg.vocab_size - 1)
        return prefill_scores(self.params, self.cfg, toks, lanes=self.lanes)


def rank_result(stage: EnrichmentStage, ds, result: ChannelResult,
                channel_rows: torch.Tensor, group_sids: torch.Tensor,
                counts: Optional[torch.Tensor] = None):
    """Score and budget-prune one stacked ChannelResult.

    Scores the (C, Rm) candidate slots in one ``stage.score`` call and
    invalidates every pair ranked at or past ``stage.budget`` under (score
    desc, ravel asc). Returns ``(pruned_result, ranked_pairs, ranked_sids)``
    with the per-channel (C,) int32 counts of pruned pairs and of their
    member sIDs (the member-count pass delivery uses). ``budget=None``
    passes the result through untouched.

    A slot's pairs share its score and lie contiguously in ravel order, so
    the pair rank is a slot rank: the top ``min(budget, Rm)`` slots by
    score, ties to the lower slot index (a stable descending sort: the
    reference's ``lax.top_k`` breaks ties that way and ``torch.topk``
    promises no order), with the budget handed down the ranked slots by
    cumulative valid-pair count; a partly funded slot keeps its first valid
    pairs in target order. Slots with no valid pair score -inf. Scores must
    be finite."""
    C, Rm, _ = result.pair_valid.shape
    dev = result.pair_valid.device
    budget = stage.budget
    if budget is None:
        zeros = torch.zeros((C,), dtype=I32, device=dev)
        return result, zeros, zeros
    rows = result.matched_rows                                # (C, Rm)
    tokens = ds.fields[torch.clamp(rows, min=0).long() % ds.capacity]
    ch = channel_rows.to(dev)[:, None].expand(rows.shape)
    scores = stage.score(tokens.reshape(C * Rm, -1), ch.reshape(-1),
                         rows.reshape(-1))
    scores = torch.as_tensor(scores, dtype=torch.float32,
                             device=dev).reshape(C, Rm)
    valid3 = result.pair_valid
    vc = valid3.sum(dim=2, dtype=I32)                         # (C, Rm)
    masked = torch.where(vc > 0, scores, float("-inf"))
    k = min(int(budget), Rm)
    idx = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :k]
    vc_top = torch.gather(vc, 1, idx)
    before = torch.cumsum(vc_top, dim=1, dtype=I32) - vc_top  # ranked above
    keep_top = torch.minimum(torch.clamp(budget - before, min=0), vc_top)
    keep_per_slot = torch.zeros((C, Rm), dtype=I32, device=dev).scatter_(
        1, idx, keep_top)
    rank_in_slot = torch.cumsum(valid3, dim=2, dtype=I32) - 1
    keep = valid3 & (rank_in_slot < keep_per_slot[:, :, None])
    pruned2 = (valid3 & ~keep).reshape(C, -1)
    ranked_pairs = pruned2.sum(dim=1, dtype=I32)
    members = _member_counts(group_sids, pruned2,
                             result.pair_targets.reshape(C, -1), counts)
    ranked_sids = members.sum(dim=1, dtype=I32)
    out = result._replace(
        pair_valid=keep,
        pair_rows=torch.where(keep, result.pair_rows, -1),
        pair_targets=torch.where(keep, result.pair_targets, -1))
    return out, ranked_pairs, ranked_sids
