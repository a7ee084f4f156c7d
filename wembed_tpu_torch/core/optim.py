"""Gradient-ascent optimizers with cooling.

Counterpart of ``wembed_tpu/core/optim.py``: the reference's AdamOptimizer
(reference src/embeddingLib/src/gradientOptimizer/AdamOptimizer.cpp:18-34),
standard Adam moments with bias correction, the step SCALED by
coolingFactor^t and applied as ASCENT (forces point uphill), and the
SimpleOptimizer (clip + cooled learning rate, SimpleOptimizer.cpp:17-41).
The update order matters for trajectory parity and is that of the JAX
package.  The step-dependent scalars (powers of t) are computed on the
host in the working dtype, as the JAX package computes them in it, and
reach the update as a (3,) tensor on the update's device (``Schedule``):
a step reads no host value of t, so a captured step (``core/step.py:
StepGraph``) replays with each iteration's own scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .options import EmbedderOptions, OptimizerType


class AdamParams(NamedTuple):
    learning_rate: float
    cooling_factor: float
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def adam_row(t: int, hp: AdamParams, dtype: torch.dtype, device: torch.device) -> tuple:
    """(cooling^t * lr, c1, c2) of step ``t`` in ``dtype``: the bias
    corrections c = 1 - beta^t, or on a CUDA device their reciprocals.
    ATen divides a CUDA tensor by a host scalar as a multiply by the
    scalar's reciprocal in the tensor's dtype, and a CPU tensor by a true
    division; each device's row keeps that form, so that the update rounds
    exactly as the update by host scalars rounds on that device."""
    f = _np_dtype(dtype)
    tf = f(t)
    cooling = np.power(f(hp.cooling_factor), tf)
    c1 = f(1.0) - np.power(f(hp.beta1), tf)
    c2 = f(1.0) - np.power(f(hp.beta2), tf)
    if torch.device(device).type == "cuda":
        c1, c2 = f(1.0) / c1, f(1.0) / c2
    return cooling * f(hp.learning_rate), c1, c2


def simple_row(t: int, learning_rate: float, cooling_factor: float) -> tuple:
    """(learning_rate * cooling_factor^t, 0, 0): SIMPLE's cooled learning
    rate, the power in f32 and the product in f64, as the host-scalar
    update formed it."""
    cooling = float(np.power(np.float32(cooling_factor), np.float32(t)))
    return learning_rate * cooling, 0.0, 0.0


def _unbiased(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x`` over its bias correction, in the form of ``adam_row``."""
    return x * c if x.is_cuda else x / c


def adam_update(
    params: torch.Tensor,  # (n, d) positions
    grads: torch.Tensor,  # (n, d) ascent directions
    m: torch.Tensor,
    v: torch.Tensor,
    t: int | torch.Tensor,
    hp: AdamParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam ascent step; returns (params, m, v).

    ``t`` is the step count AFTER the increment (t >= 1; the reference
    does ``t++`` at the top of update, AdamOptimizer.cpp:23), or that
    step's (3,) row of a ``Schedule``.
    """
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(adam_row(t, hp, params.dtype, params.device), dtype=params.dtype,
                         device=params.device)
    lr_t, c1, c2 = t.unbind()
    f = _np_dtype(params.dtype)
    m = hp.beta1 * m + (1.0 - hp.beta1) * grads
    v = hp.beta2 * v + (1.0 - hp.beta2) * grads * grads
    m_hat = _unbiased(m, c1)
    v_hat = _unbiased(v, c2)
    step = lr_t * m_hat / (torch.sqrt(v_hat) + float(f(hp.epsilon)))
    return params + step, m, v


def simple_update(
    params: torch.Tensor,
    grads: torch.Tensor,
    t: int | torch.Tensor,
    learning_rate: float,
    cooling_factor: float,
    max_displacement: float = 1.0,
) -> torch.Tensor:
    """Per-coordinate clip then cooled learning rate
    (reference SimpleOptimizer.cpp:17-41); ``t`` as for ``adam_update``."""
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(simple_row(t, learning_rate, cooling_factor), dtype=params.dtype,
                         device=params.device)
    clipped = torch.clamp(grads, -max_displacement, max_displacement)
    return params + t[0] * clipped


class Schedule:
    """Every step's optimizer scalars on one device, a (3,) row for each t
    = 1, 2, ...: ``adam_row`` or ``simple_row`` in the working dtype,
    computed on the host once a row and copied to the device in blocks
    (a block of rows costs one synchronising copy).  A step reads its row
    with ``at(t)``, a view on the device, so that no host scalar of t
    enters the step."""

    _BLOCK = 256  # rows added at a time, at least

    def __init__(self, opts: EmbedderOptions, dtype: torch.dtype, device: torch.device):
        self._dtype, self._device = dtype, torch.device(device)
        if opts.optimizer_type is OptimizerType.SIMPLE:
            self._row = lambda t: simple_row(t, opts.learning_rate, opts.cooling_factor)
        else:
            hp = AdamParams(opts.learning_rate, opts.cooling_factor)
            self._row = lambda t: adam_row(t, hp, dtype, self._device)
        self._table = torch.empty((0, 3), dtype=dtype, device=self._device)

    def at(self, t: int) -> torch.Tensor:
        """The (3,) row of step ``t`` (t >= 1)."""
        have = self._table.shape[0]
        if t > have:
            rows = [self._row(s) for s in range(have + 1, max(t, 2 * have, self._BLOCK) + 1)]
            block = torch.tensor(np.asarray(rows, dtype=_np_dtype(self._dtype)), device=self._device)
            self._table = torch.cat([self._table, block])
        return self._table[t - 1]
