"""UserParameters dataset (paper §4.2).

"a dataset which will be created by the system when a channel is created ...
includes fields for the channel's parameter(s) and the number of subscriptions
interested in each. These fields facilitate the dynamic addition or removal of
parameters as subscriber interests evolve."

Channel parameters come from small categorical domains (states, countries,
topics), so the realization is a dense host refcount table over the domain;
``mask`` uploads its membership bitmap so the early semi-join is an O(1)
gather on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class UserParameters:
    """refcount[v] = number of live subscriptions with parameter v."""

    refcount: np.ndarray  # (domain,) int64

    @property
    def domain(self) -> int:
        return int(self.refcount.shape[0])

    @property
    def num_distinct(self) -> int:
        return int((self.refcount > 0).sum())

    @staticmethod
    def create(domain: int) -> "UserParameters":
        return UserParameters(np.zeros((domain,), dtype=np.int64))

    @staticmethod
    def from_params(params: np.ndarray, domain: int) -> "UserParameters":
        up = UserParameters.create(domain)
        np.add.at(up.refcount, np.asarray(params, dtype=np.int64), 1)
        return up

    def add(self, param: int) -> None:
        if not 0 <= param < self.domain:
            raise ValueError(f"param {param} out of [0, {self.domain})")
        self.refcount[param] += 1

    def add_bulk(self, params: np.ndarray) -> None:
        """Vectorized ``add``: one bincount instead of S increments."""
        params = np.asarray(params, dtype=np.int64).ravel()
        if params.size == 0:
            return
        if int(params.min()) < 0 or int(params.max()) >= self.domain:
            raise ValueError(f"params out of [0, {self.domain})")
        self.refcount += np.bincount(params, minlength=self.domain)

    def remove(self, param: int) -> None:
        if self.refcount[param] <= 0:
            raise ValueError(f"no live subscription with param {param}")
        self.refcount[param] -= 1

    def remove_bulk(self, params: np.ndarray) -> None:
        """Vectorized ``remove``: one bincount instead of S decrements.
        Validates the whole batch BEFORE mutating (atomic on failure)."""
        params = np.asarray(params, dtype=np.int64).ravel()
        if params.size == 0:
            return
        if int(params.min()) < 0 or int(params.max()) >= self.domain:
            raise ValueError(f"params out of [0, {self.domain})")
        dec = np.bincount(params, minlength=self.domain)
        if (self.refcount < dec).any():
            raise ValueError("remove_bulk exceeds live refcounts")
        self.refcount -= dec

    def mask(self, device: DeviceLike = "cuda") -> torch.Tensor:
        """(domain,) bool tensor on ``device`` for the early semi-join."""
        return torch.as_tensor(self.refcount > 0, device=resolve_device(device))


def semi_join(param_values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N,) record param values x (domain,) membership -> (N,) keep mask.

    The augmented plan's first join (records x UserParameters): prunes every
    record whose parameter value no subscriber asked for, *before* the wide
    join with the subscription dataset.
    """
    d = mask.shape[0]
    clipped = torch.clamp(param_values, 0, d - 1).long()
    in_domain = (param_values >= 0) & (param_values < d)
    return mask[clipped] & in_domain
