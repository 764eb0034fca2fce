"""Robust kernels and chi2 gates (port of viorb_tpu/optim/robust.py):
5.991 mono 2-dof, 7.815 stereo 3-dof, 16.919 / 21.666 VI 9-dof at 0.95 /
0.99."""

from __future__ import annotations

import torch

CHI2_MONO_2DOF = 5.991
CHI2_STEREO_3DOF = 7.815
CHI2_VI_9DOF = 16.919
CHI2_VI_9DOF_99 = 21.666


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel: 1 inside, delta/|r| outside.
    chi2 is the squared whitened residual norm; delta2 the squared
    threshold."""
    return torch.where(
        chi2 <= delta2,
        torch.ones_like(chi2),
        torch.sqrt(delta2 / chi2.clamp(min=1e-12)),
    )
