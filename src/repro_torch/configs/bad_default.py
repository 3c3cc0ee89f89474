"""The paper's own workload configuration: datasets, channels, rates.

Mirrors §5.1: 2M preloaded EnrichedTweets, 2000 tweets/s ingest, ~30 KB
payloads, 1M subscribers, 10-minute periods, frame sizes 40/80 KB. The
CPU-scale variant shrinks counts, never structure. The same values as the
reference package's ``configs/bad_default.py``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class BADWorkload:
    preload_records: int = 2_000_000
    tweets_per_second: int = 2_000
    period_s: int = 600
    payload_bytes: int = 30 * 1024
    num_subscribers: int = 1_000_000
    frame_bytes: int = 40 * 1024
    num_brokers: int = 4
    num_states: int = 50


def get_config() -> BADWorkload:
    return BADWorkload()


def cpu_scale(w: BADWorkload | None = None, factor: int = 64) -> BADWorkload:
    w = w or get_config()
    return dataclasses.replace(
        w,
        preload_records=max(1024, w.preload_records // factor),
        tweets_per_second=max(64, w.tweets_per_second // 4),
        period_s=30,
        num_subscribers=max(4096, w.num_subscribers // factor),
    )
