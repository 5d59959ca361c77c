"""Optimal transport with a dustbin, in log space — port of
pixelspointspolygons_tpu/ops/sinkhorn.py (:14-57; reference
models/pix2poly/model_pix2poly.py:35-66, SuperGlue's log_optimal_transport).

Plain PyTorch: in the JAX package this is a `lax.scan` that XLA fuses, not a
Pallas kernel. A one-launch Hopper kernel for it is planned (ROADMAP §2,
K3). Pix2Poly's teacher-forced forward and the fixed-length decode of the
bench use it; the predictor uses the raw scores instead.
"""

from __future__ import annotations

import torch


def log_sinkhorn(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """Z: (B, M, N); log_mu: (B, M); log_nu: (B, N). `iters` alternating row
    and column logsumexp updates from u = v = 0."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, iters: int) -> torch.Tensor:
    """Augment scores (B, M, N) with a dustbin row and column of score
    `alpha` (a scalar), run Sinkhorn, return the (B, M+1, N+1) log coupling."""
    b, m, n = scores.shape
    dev, dt = scores.device, scores.dtype
    ms = torch.tensor(float(m), dtype=torch.float32, device=dev)
    ns = torch.tensor(float(n), dtype=torch.float32, device=dev)

    alpha = torch.as_tensor(alpha, dtype=dt, device=dev).expand(b, 1, 1)
    couplings = torch.cat(
        [
            torch.cat([scores, alpha.expand(b, m, 1)], dim=-1),
            torch.cat([alpha.expand(b, 1, n), alpha], dim=-1),
        ],
        dim=1,
    )

    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    Z = log_sinkhorn(couplings, log_mu.expand(b, m + 1), log_nu.expand(b, n + 1), iters)
    return Z - norm
