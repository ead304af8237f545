"""Batched Sim3 / SE3 RANSAC from 3D-3D correspondences.

Counterpart of plvs_tpu/solvers/sim3_solver.py: every hypothesis at once —
S minimal 3-point sets, S closed-form Horn alignments through one batched
3x3 SVD, one [S, N] distance matrix for the inlier counts, the best
hypothesis by argmax, then one weighted Horn refit on its inliers.

The sampling is split out. ``sim3_ransac_from_samples`` scores given
``[n_hyp, 3]`` index samples; ``sim3_ransac`` draws them from an explicit
``torch.Generator`` (the JAX package draws with ``jax.random.choice``,
whose stream PyTorch cannot reproduce, so the tests hand JAX's samples to
``sim3_ransac_from_samples``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _signed_rotation(cov: torch.Tensor):
    """(R, D, sign(det)) of the Horn rotation U diag(1, 1, sign) V^T."""
    U, D, Vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    one = torch.ones_like(sign)
    diag = torch.stack([one, one, sign], -1)
    return (U * diag[..., None, :]) @ Vt, D, diag


def horn_alignment(P: torch.Tensor, Q: torch.Tensor, with_scale: bool = True):
    """Closed-form alignment Q ~= s R P + t for [..., N, 3] point sets,
    batched over the leading axes. Returns (s, R, t)."""
    muP = P.mean(-2, keepdim=True)
    muQ = Q.mean(-2, keepdim=True)
    Pc = P - muP
    Qc = Q - muQ
    cov = Qc.transpose(-1, -2) @ Pc
    R, D, diag = _signed_rotation(cov)
    if with_scale:
        varP = (Pc * Pc).sum((-2, -1))
        s = (D * diag).sum(-1) / torch.clamp(varP, min=1e-12)
    else:
        s = torch.ones(cov.shape[:-2], dtype=P.dtype, device=P.device)
    t = muQ[..., 0, :] - s[..., None] * _mv(R, muP[..., 0, :])
    return s, R, t


class RansacResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor


def sim3_ransac_from_samples(P: torch.Tensor, Q: torch.Tensor,
                             valid: torch.Tensor, samples: torch.Tensor,
                             inlier_thresh: float = 0.05,
                             with_scale: bool = True) -> RansacResult:
    """Score the hypotheses of ``samples`` [n_hyp, 3] (indices into the
    [N, 3] correspondences P -> Q) and refit the best: Q = s R P + t."""
    samples = samples.long()
    s, R, t = horn_alignment(P[samples], Q[samples], with_scale)
    QP = s[:, None, None] * torch.einsum("hij,nj->hni", R, P) + t[:, None, :]
    d2 = ((QP - Q[None]) ** 2).sum(-1)                      # [H, N]
    inl = (d2 < inlier_thresh ** 2) & valid[None, :]
    counts = inl.sum(-1)
    sane = (s > 0.1) & (s < 10.0)
    counts = torch.where(sane, counts, -1)
    inliers = inl[torch.argmax(counts)]

    # one weighted Horn pass on the best hypothesis' inliers
    w = inliers.to(P.dtype)[:, None]
    n_w = torch.clamp(w.sum(), min=1.0)
    muP = (P * w).sum(0) / n_w
    muQ = (Q * w).sum(0) / n_w
    Pc = (P - muP) * w
    Qc = (Q - muQ) * w
    Rr, D, diag = _signed_rotation(Qc.T @ Pc)
    if with_scale:
        sr = (D * diag).sum() / torch.clamp((Pc * Pc).sum(), min=1e-12)
    else:
        sr = torch.ones((), dtype=P.dtype, device=P.device)
    tr = muQ - sr * _mv(Rr, muP)
    Qhat = sr * (P @ Rr.T) + tr
    inl_r = (((Qhat - Q) ** 2).sum(-1) < inlier_thresh ** 2) & valid
    return RansacResult(sr, Rr, tr, inl_r, inl_r.sum())


def draw_samples(valid: torch.Tensor, generator: torch.Generator,
                 n_hyp: int = 256) -> torch.Tensor:
    """[n_hyp, 3] minimal sets drawn with replacement, biased to valid
    entries (the JAX package's probabilities: valid + 1e-6, normalised)."""
    probs = valid.to(torch.float32) + 1e-6
    return torch.multinomial(probs / probs.sum(), n_hyp * 3, replacement=True,
                             generator=generator).reshape(n_hyp, 3)


def sim3_ransac(P: torch.Tensor, Q: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator, n_hyp: int = 256,
                inlier_thresh: float = 0.05,
                with_scale: bool = True) -> RansacResult:
    """RANSAC for Q = s R P + t with samples from ``generator`` (on the
    tensors' device). ``inlier_thresh`` is a 3D distance."""
    return sim3_ransac_from_samples(
        P, Q, valid, draw_samples(valid, generator, n_hyp),
        inlier_thresh=inlier_thresh, with_scale=with_scale)
