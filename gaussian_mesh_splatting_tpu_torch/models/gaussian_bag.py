"""GaussianBag: the activated, render-ready Gaussian attributes.

Every model variant is a function ``state -> GaussianBag``; the rasterizer
consumes only the bag. `alive` is the padding mask of fixed-capacity
buffers: dead rows are culled by the rasterizer whatever their values.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GaussianBag:
    xyz: torch.Tensor  # (N, 3) world positions
    scaling: torch.Tensor  # (N, 3) activated (positive) scales
    rotation: torch.Tensor  # (N, 4) unit quaternions (w, x, y, z)
    opacity: torch.Tensor  # (N, 1) activated opacity in (0, 1)
    shs: torch.Tensor  # (N, 3, K) SH coefficients, channel-major
    alive: torch.Tensor  # (N,) bool padding/alive mask

    @property
    def num_gaussians(self) -> int:
        return self.xyz.shape[0]


def concat_bags(bags: list[GaussianBag]) -> GaussianBag:
    """One bag of every bag's rows, in order."""
    return GaussianBag(**{f.name: torch.cat([getattr(b, f.name) for b in bags], dim=0)
                          for f in dataclasses.fields(GaussianBag)})


def features_to_shs(features_dc: torch.Tensor, features_rest: torch.Tensor) -> torch.Tensor:
    """features_dc (N, 1, 3) + features_rest (N, K-1, 3) -> (N, 3, K)."""
    return torch.cat([features_dc, features_rest], dim=1).transpose(1, 2)


def shs_to_features(shs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `features_to_shs`."""
    feats = shs.transpose(1, 2)  # (N, K, 3)
    return feats[:, :1, :], feats[:, 1:, :]
