"""Plain euclidean oracle for the spatial join (TweetsAboutCrime).

This is what the ``"oracle"`` backend joins with. The ``"pallas"`` backend
uses ``ops.spatial_match``, whose expansion form can round differently on
pairs that lie on the radius.
"""
from __future__ import annotations

import numpy as np
import torch


def spatial_match(tweet_locs: torch.Tensor, user_locs: torch.Tensor,
                  radius) -> torch.Tensor:
    """(R, 2) x (U, 2) -> (R, U) bool: euclidean distance < radius; stacked
    (C, R, 2) x (C, U, 2) with a (C,) radius (or one for all) -> (C, R, U)."""
    d0 = tweet_locs[..., :, None, 0] - user_locs[..., None, :, 0]
    d1 = tweet_locs[..., :, None, 1] - user_locs[..., None, :, 1]
    dist2 = d0 * d0 + d1 * d1
    if tweet_locs.dim() == 3:
        r = torch.as_tensor(radius, dtype=torch.float32,
                            device=tweet_locs.device).expand(
                                tweet_locs.shape[0])
        return dist2 < (r * r)[:, None, None]
    r2 = torch.tensor(np.float32(radius) ** 2, dtype=tweet_locs.dtype,
                      device=tweet_locs.device)
    return dist2 < r2
