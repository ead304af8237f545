"""Dense forward-mode Jacobians for the fixed-trip Gauss-Newton loops.

Counterpart of ``jax.jacfwd`` inside the JAX package's ``lax.scan``
solvers: one dual pass pushes all n tangent directions through the residual
function at once, as a batch of n rows. The work is fixed by the shapes and
nothing is read back to the host, so a loop of such steps launches the same
kernels every iteration.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def jacobian(residuals, x: torch.Tensor) -> torch.Tensor:
    """J [R, n] of ``residuals`` at x [n]. ``residuals`` maps a batch
    [B, n] of parameter vectors to [B, R] residuals."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    with fwAD.dual_level():
        out = residuals(fwAD.make_dual(x[None].expand(n, n).clone(), eye))
        return fwAD.unpack_dual(out).tangent.T
