"""Depth-sensor noise model: quadratic sigma_Z(z) and relative weights.

Counterpart of plvs_tpu/utils/depth_model.py (structured-light / ToF depth
noise grows quadratically with range):

    sigma_Z(z) = a + b * (z - z0)^2

Every step is a float32 tensor operation, constants included, as the JAX
package computes it.
"""

from __future__ import annotations

import torch

SIGMA_A = 0.0012   # metres, noise floor
SIGMA_B = 0.0019   # metres^-1, quadratic growth
Z0 = 0.4           # metres, sweet-spot range
Z_MIN = 0.5        # metres, range where sigma is treated as minimal


def sigma_z(z: torch.Tensor, a: float = SIGMA_A, b: float = SIGMA_B,
            z0: float = Z0) -> torch.Tensor:
    """Depth standard deviation at range z (metres)."""
    return a + b * torch.square(torch.clamp(z, min=0.0) - z0)


def sigma_z_min_over_sigma_z(z: torch.Tensor, a: float = SIGMA_A,
                             b: float = SIGMA_B, z0: float = Z0,
                             z_min: float = Z_MIN) -> torch.Tensor:
    """Relative confidence weight in (0, 1]: 1 near the sensor, decaying
    quadratically with range."""
    s_min = sigma_z(torch.tensor(z_min, dtype=z.dtype, device=z.device),
                    a, b, z0)
    return torch.clamp(s_min / sigma_z(z, a, b, z0), 0.0, 1.0)
