"""Small numeric utilities shared by the equivariant ops."""

from __future__ import annotations

import torch


def safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm whose gradient is exactly zero (not NaN) at v = 0.

    Padded edges carry zero vectors; a plain norm yields NaN in the
    backward pass there.  sqrt(max(sum v^2, eps^2)) is exact for any real
    edge (r >> eps).
    """
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, eps * eps))
