"""Seed management.

Counterpart of ``wembed_tpu/utils/rng.py``.  The reference uses one global
mt19937 (reference src/utilLib/src/Rand.cpp:8-21, ``Rand::setSeed``).  The
port keeps one host numpy Generator as the seed stream; every embedder
draws its own ``torch.Generator`` from it (``new_generator``), in place of
the JAX package's ``new_key``.  torch cannot reproduce ``jax.random``
streams, so parity with the JAX package is established by injecting
identical initial coordinates and weights.
"""

from __future__ import annotations

import numpy as np
import torch

_host_rng = np.random.default_rng()


def set_seed(seed: int) -> None:
    """Reseed the host stream; device generators derive from it."""
    global _host_rng
    _host_rng = np.random.default_rng(seed)


def host_rng() -> np.random.Generator:
    return _host_rng


def new_generator(device: torch.device | str) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device``, seeded from the host stream."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_host_rng.integers(0, 2**63 - 1)))
    return gen
