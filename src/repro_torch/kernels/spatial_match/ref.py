"""Plain euclidean oracle for the spatial join (TweetsAboutCrime).

This is what the ``"oracle"`` backend joins with. The ``"pallas"`` backend
uses ``ops.spatial_match``, whose expansion form can round differently on
pairs that lie on the radius.
"""
from __future__ import annotations

import numpy as np
import torch


def spatial_match(tweet_locs: torch.Tensor, user_locs: torch.Tensor,
                  radius: float) -> torch.Tensor:
    """(R, 2) x (U, 2) -> (R, U) bool: euclidean distance < radius."""
    d = tweet_locs[:, None, :] - user_locs[None, :, :]
    dist2 = (d * d).sum(dim=-1)
    r2 = torch.tensor(np.float32(radius) ** 2, dtype=tweet_locs.dtype,
                      device=tweet_locs.device)
    return dist2 < r2
