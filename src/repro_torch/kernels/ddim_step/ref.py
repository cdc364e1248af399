"""Plain PyTorch version of the fused DDIM-step kernel, and the
coefficients both take.

``ddim_coefs`` folds the x0-prediction combine of one deterministic
(eta = 0) DDIM update into two float32 scalars, with the same float32
operations as the JAX wrapper ``repro.kernels.ddim_step.ops.ddim_step``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def ddim_coefs(alpha_t, alpha_prev) -> Tuple[float, float]:
    """-> (c1, c2), float32 values as Python floats:
    c1 = sqrt(a_p / a_t), c2 = sqrt(1 - a_p) - c1 * sqrt(1 - a_t)."""
    a_t, a_p = np.float32(alpha_t), np.float32(alpha_prev)
    one = np.float32(1.0)
    c1 = np.sqrt(a_p / a_t)
    c2 = np.sqrt(one - a_p) - c1 * np.sqrt(one - a_t)
    return float(c1), float(c2)


def ddim_step_ref(x: torch.Tensor, eps: torch.Tensor, c1: float,
                  c2: float) -> torch.Tensor:
    """``c1 * x + c2 * eps``, each product and the sum rounded to float32."""
    return x * c1 + eps * c2
