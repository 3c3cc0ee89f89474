"""Record model: fixed-width struct-of-arrays records + the ActiveDataset.

Every predicate-addressable field is an int32 column (categorical fields are
dictionary-encoded on the host), spatial locations are a float32 (N, 2)
column. The ActiveDataset is a preallocated ring buffer on one device:
``size`` counts records ever ingested, ``row_id = size_at_ingest + offset``
is the stable primary key ("tid") the BAD index stores, and ``timestamp``
is the LSM-style time filter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Schema:
    """Names -> int-column index. All predicate fields are int32 columns."""

    fields: Tuple[str, ...]
    has_location: bool = True

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    def index(self, name: str) -> int:
        return self.fields.index(name)


# The paper's running example (Fig. 2), dictionary-encoded.
ENRICHED_TWEET_SCHEMA = Schema(
    fields=(
        "state",            # 0..49 (dictionary: US states)
        "about_country",    # 0 == "US"
        "retweet_count",
        "threatening_rate",  # 0..10
        "hate_speech_rate",  # 0..10
        "weapon_mentioned",  # 0/1
        "drug_activity",     # categorical; 3 == "Manufacturing Drugs"
        "lang",              # 0 en, 1 pt, ... (for the real-world channels)
        "country",           # world country code (real-world channels)
        "timestamp",         # ingestion timestamp (seconds)
    ),
    has_location=True,
)

STATE, ABOUT_COUNTRY, RETWEET_COUNT, THREATENING_RATE, HATE_SPEECH_RATE, \
    WEAPON_MENTIONED, DRUG_ACTIVITY, LANG, COUNTRY, TIMESTAMP = range(10)


@dataclasses.dataclass
class RecordBatch:
    """A batch of fixed-width records (struct of arrays).

    fields:   (N, F) int32
    location: (N, 2) float32 (zeros when the schema has no location)
    host_fields: the (N, F) int32 numpy array the batch was built from, when
        it was built from one; ingest reads timestamps from it instead of
        copying them back from the device
    """

    fields: torch.Tensor
    location: torch.Tensor
    host_fields: Optional[np.ndarray] = dataclasses.field(default=None,
                                                          repr=False)

    @property
    def num_records(self) -> int:
        return int(self.fields.shape[0])

    @staticmethod
    def from_numpy(fields: np.ndarray, location: Optional[np.ndarray] = None,
                   device: DeviceLike = "cuda") -> "RecordBatch":
        dev = resolve_device(device)
        host = np.asarray(fields, dtype=np.int32)
        f = to_device(host, dev)
        if location is None:
            loc = torch.zeros((f.shape[0], 2), dtype=torch.float32, device=dev)
        else:
            loc = to_device(np.asarray(location, dtype=np.float32), dev)
        return RecordBatch(f, loc, host)


def to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of ``host`` on ``dev``. To a card it is staged in
    freshly allocated pinned memory and copied without blocking the host
    (a blocking copy from pageable memory waits for all the work queued on
    the stream); PyTorch's pinned allocator records the copy on the stream
    and reuses the block only after it completed."""
    if dev.type != "cuda":
        return torch.tensor(host, device=dev).contiguous()
    staged = torch.empty(host.shape, dtype=_TORCH_DTYPES[host.dtype],
                         pin_memory=True)
    staged.numpy()[...] = host
    return staged.to(dev, non_blocking=True)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


@dataclasses.dataclass
class ActiveDataset:
    """Preallocated ring buffer of records.

    fields:   (cap, F) int32
    location: (cap, 2) float32
    size:     () int32 -- total records ever ingested (monotone)

    Row id r lives at slot ``r % cap`` and is valid iff
    ``size - cap <= r < size``.
    """

    fields: torch.Tensor
    location: torch.Tensor
    size: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.fields.shape[0])

    @property
    def device(self) -> torch.device:
        return self.fields.device

    @staticmethod
    def create(capacity: int, schema: Schema = ENRICHED_TWEET_SCHEMA,
               device: DeviceLike = "cuda") -> "ActiveDataset":
        dev = resolve_device(device)
        return ActiveDataset(
            fields=torch.zeros((capacity, schema.num_fields), dtype=torch.int32,
                               device=dev),
            location=torch.zeros((capacity, 2), dtype=torch.float32,
                                 device=dev),
            size=torch.zeros((), dtype=torch.int32, device=dev),
        )


def append(ds: ActiveDataset, batch: RecordBatch) -> torch.Tensor:
    """Append a batch IN PLACE (the reference donates its buffers; here the
    dataset's tensors are overwritten and ``ds.size`` advances). Returns the
    (N,) int32 row ids of the appended records."""
    n = batch.num_records
    row_ids = ds.size + torch.arange(n, dtype=torch.int32, device=ds.device)
    slots = (row_ids % ds.capacity).long()
    ds.fields[slots] = batch.fields
    ds.location[slots] = batch.location
    ds.size += n
    return row_ids


def gather_rows(ds: ActiveDataset, row_ids: torch.Tensor) -> RecordBatch:
    """Gather records by stable row id (caller guarantees ids are live)."""
    slots = (row_ids % ds.capacity).long()
    return RecordBatch(ds.fields[slots], ds.location[slots])


# ---------------------------------------------------------------------------
# Host-side dictionary encoding helpers (control plane)
# ---------------------------------------------------------------------------


class Dictionary:
    """String -> dense int code, grown on first sight (host side only)."""

    def __init__(self) -> None:
        self._codes: Dict[str, int] = {}

    def encode(self, value: str) -> int:
        if value not in self._codes:
            self._codes[value] = len(self._codes)
        return self._codes[value]

    def decode(self, code: int) -> str:
        for k, v in self._codes.items():
            if v == code:
                return k
        raise KeyError(code)

    def __len__(self) -> int:
        return len(self._codes)
