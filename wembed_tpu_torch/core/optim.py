"""Gradient-ascent optimizers with cooling.

Counterpart of ``wembed_tpu/core/optim.py``: the reference's AdamOptimizer
(reference src/embeddingLib/src/gradientOptimizer/AdamOptimizer.cpp:18-34),
standard Adam moments with bias correction, the step SCALED by
coolingFactor^t and applied as ASCENT (forces point uphill), and the
SimpleOptimizer (clip + cooled learning rate, SimpleOptimizer.cpp:17-41).
The update order matters for trajectory parity and is that of the JAX
package.  The step-dependent scalars (powers of t) are computed on the
host in the working dtype, as the JAX package computes them in it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamParams(NamedTuple):
    learning_rate: float
    cooling_factor: float
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def adam_update(
    params: torch.Tensor,  # (n, d) positions
    grads: torch.Tensor,  # (n, d) ascent directions
    m: torch.Tensor,
    v: torch.Tensor,
    t: int,  # step count AFTER increment (t >= 1)
    hp: AdamParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam ascent step; returns (params, m, v).

    Caller increments ``t`` first (the reference does ``t++`` at the top of
    update, AdamOptimizer.cpp:23).
    """
    f = _np_dtype(params.dtype)
    tf = f(t)
    cooling = np.power(f(hp.cooling_factor), tf)
    m = hp.beta1 * m + (1.0 - hp.beta1) * grads
    v = hp.beta2 * v + (1.0 - hp.beta2) * grads * grads
    m_hat = m / float(f(1.0) - np.power(f(hp.beta1), tf))
    v_hat = v / float(f(1.0) - np.power(f(hp.beta2), tf))
    step = float(cooling * f(hp.learning_rate)) * m_hat / (
        torch.sqrt(v_hat) + float(f(hp.epsilon))
    )
    return params + step, m, v


def simple_update(
    params: torch.Tensor,
    grads: torch.Tensor,
    t: int,
    learning_rate: float,
    cooling_factor: float,
    max_displacement: float = 1.0,
) -> torch.Tensor:
    """Per-coordinate clip then cooled learning rate
    (reference SimpleOptimizer.cpp:17-41)."""
    clipped = torch.clamp(grads, -max_displacement, max_displacement)
    cooling = float(np.power(np.float32(cooling_factor), np.float32(t)))
    return params + learning_rate * cooling * clipped
