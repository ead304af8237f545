"""Robust loss kernels as IRLS weights (counterpart of
plvs_tpu/solvers/robust.py)."""

from __future__ import annotations

import torch

# chi-square 95% quantiles used by the reference as inlier gates
CHI2_2D = 5.991   # 2 dof (mono reprojection)
CHI2_3D = 7.815   # 3 dof (stereo reprojection)


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber loss for squared error chi2:
    min(1, delta / sqrt(chi2))."""
    s = torch.clamp(chi2, min=1e-12)
    return torch.clamp(torch.sqrt(delta2 / s), max=1.0)


def cauchy_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Cauchy loss rho(s) = d^2 log(1 + s / d^2)."""
    return 1.0 / (1.0 + chi2 / delta2)


def tukey_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of Tukey's biweight (hard redescending): (1 - s / d^2)^2
    inside the threshold, 0 outside."""
    u = 1.0 - chi2 / delta2
    return torch.where(chi2 <= delta2, u * u, torch.zeros_like(u))
