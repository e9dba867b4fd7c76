"""Radial basis functions and cutoff envelopes.

Port of ``sevennet_finetuning_tpu/ops/radial.py``: trainable Bessel
basis, polynomial cutoff (DimeNet form) and the XPLOR switching function;
and the Gaussian basis with no envelope of the 'equiformer_v2' family.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bessel_init(cutoff: float, num_basis: int = 8) -> np.ndarray:
    """Initial (trainable) frequencies n*pi/r_c, n = 1..num_basis."""
    return np.arange(1, num_basis + 1, dtype=np.float64) * math.pi / cutoff


def bessel_basis(
    r: torch.Tensor,
    coeffs: torch.Tensor,
    cutoff: float,
    normalize: str = 'nequip',
) -> torch.Tensor:
    """sin(c_n r)/r basis; prefactor 2/r_c ('nequip') or sqrt(2/r_c)."""
    if normalize == 'nequip':
        prefactor = 2.0 / cutoff
    elif normalize == 'ortho':
        prefactor = math.sqrt(2.0 / cutoff)
    else:
        raise ValueError(f'unknown bessel normalize: {normalize}')
    # r=0 occurs on padded edges; guard the division so neither the value
    # nor its gradient is NaN there (masked out downstream anyway)
    ur = torch.clamp_min(r[..., None], 1e-6)
    return prefactor * torch.sin(coeffs * ur) / ur


def poly_cutoff(r: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial envelope, 1 at r=0 and 0 with p-1 zero derivatives
    at r=r_c (arXiv:2003.03123), clamped to exactly 0 beyond r_c."""
    x = r / cutoff
    c0 = (p + 1.0) * (p + 2.0) / 2.0
    c1 = p * (p + 2.0)
    c2 = p * (p + 1.0) / 2.0
    val = 1.0 - c0 * x**p + c1 * x ** (p + 1) - c2 * x ** (p + 2)
    return torch.where(x < 1.0, val, torch.zeros_like(val))


def xplor_cutoff(r: torch.Tensor, cutoff: float,
                 cutoff_on: float) -> torch.Tensor:
    """XPLOR/HOOMD switching function: 1 below r_on, smooth to 0 at r_c."""
    assert cutoff_on < cutoff
    r_sq = r * r
    on_sq = cutoff_on * cutoff_on
    cut_sq = cutoff * cutoff
    sw = (
        (cut_sq - r_sq) ** 2
        * (cut_sq + 2.0 * r_sq - 3.0 * on_sq)
        / (cut_sq - on_sq) ** 3
    )
    sw = torch.where(r < cutoff, sw, torch.zeros_like(sw))
    return torch.where(r < cutoff_on, torch.ones_like(sw), sw)


def gaussian_basis(r: torch.Tensor, stop: float, num: int,
                   width: float = 2.0) -> torch.Tensor:
    """exp(-(r - mu_k)^2 / (2 (width * spacing)^2)) at ``num`` centres
    mu_k evenly from 0 to ``stop`` (fairchem's GaussianSmearing)."""
    mu = torch.linspace(0.0, stop, num, dtype=r.dtype, device=r.device)
    coeff = -0.5 / (width * stop / (num - 1)) ** 2
    return torch.exp(coeff * (r[..., None] - mu) ** 2)
