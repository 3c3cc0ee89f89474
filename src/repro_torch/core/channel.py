"""ChannelSpec: a continuous parameterized query (paper §3.3).

A channel has (i) *fixed* predicates over the active dataset — known at
channel-creation time, candidates for the BAD index; (ii) a *parameterized*
predicate binding a record field to the subscriber's parameter (the join with
the subscription dataset); (iii) optionally a *spatial* join against the
UserLocations dataset (TweetsAboutCrime); (iv) a period.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core import records as R
from repro_torch.core.predicates import Predicate


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    name: str
    fixed_preds: tuple                  # Tuple[Predicate, ...]
    # "param": record[param_field] == subscription.param (TweetsAboutDrugs /
    #          MostThreateningTweets / TrendingTweetsInACountry)
    # "spatial": subscription.param = user id; match via
    #            spatial_distance(user.location, record.location) < radius
    join: str = "param"
    param_field: int = R.STATE
    param_domain: int = 50
    spatial_radius: float = 10.0
    period_s: float = 600.0             # PERIOD PT10M
    payload_bytes: int = 30 * 1024      # ~30 KB per EnrichedTweet (paper §5.1)

    def __post_init__(self):
        if self.join not in ("param", "spatial"):
            raise ValueError(f"unknown join type {self.join}")
        object.__setattr__(self, "fixed_preds", tuple(self.fixed_preds))


def tweets_about_drugs() -> ChannelSpec:
    """Fig. 6: state=MyState AND threatening_rate=10 AND drug_activity='Manufacturing Drugs'."""
    return ChannelSpec(
        name="TweetsAboutDrugs",
        fixed_preds=(
            Predicate.parse(R.THREATENING_RATE, "==", 10),
            Predicate.parse(R.DRUG_ACTIVITY, "==", 3),
        ),
        join="param",
        param_field=R.STATE,
        param_domain=50,
    )


def most_threatening_tweets() -> ChannelSpec:
    """Fig. 8: state=MyState AND threatening_rate=10."""
    return ChannelSpec(
        name="MostThreateningTweets",
        fixed_preds=(Predicate.parse(R.THREATENING_RATE, "==", 10),),
        join="param",
        param_field=R.STATE,
        param_domain=50,
    )


def tweets_about_crime(num_conditions: int = 3) -> ChannelSpec:
    """Figs. 3/15: spatial channel with 1..5 fixed predicates (I..V)."""
    preds: List[Predicate] = [
        Predicate.parse(R.ABOUT_COUNTRY, "==", 0),        # (I)   selectivity 50%
        Predicate.parse(R.RETWEET_COUNT, ">", 10000),     # (II)  selectivity 50%
        Predicate.parse(R.HATE_SPEECH_RATE, ">", 5),      # (III) selectivity 50%
        Predicate.parse(R.THREATENING_RATE, ">", 5),      # (IV)  selectivity 20%
        Predicate.parse(R.WEAPON_MENTIONED, "==", 1),     # (V)   selectivity 20%
    ]
    if not 1 <= num_conditions <= 5:
        raise ValueError("num_conditions in [1, 5]")
    return ChannelSpec(
        name=f"TweetsAboutCrime{num_conditions}",
        fixed_preds=tuple(preds[:num_conditions]),
        join="spatial",
        param_field=R.STATE,   # unused for spatial join
        spatial_radius=10.0,
    )


def trending_tweets_in_country(lang_code: int, name: str) -> ChannelSpec:
    """Fig. 20 real-world channels: lang=X AND retweet_count>100000, by country."""
    return ChannelSpec(
        name=name,
        fixed_preds=(
            Predicate.parse(R.LANG, "==", lang_code),
            Predicate.parse(R.RETWEET_COUNT, ">", 100000),
        ),
        join="param",
        param_field=R.COUNTRY,
        param_domain=200,
        payload_bytes=3584,   # ~3.5 KB real tweets (paper §5.7)
    )
