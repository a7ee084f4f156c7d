"""Carrying an embedding state from the JAX package into the port.

A ``wembed_tpu`` checkpoint (``wembed_tpu/core/checkpoint.py``), flat or
layered, is a numpy ``.npz`` of the state arrays plus the weights (and a
layered one's layer and parent pointers); it reads here with numpy alone.
The JAX PRNG key and the span scale have no counterpart in the port and
are ignored: the new state draws a fresh ``torch.Generator`` from the host
seed stream.  ``core/checkpoint.py:load_checkpoint`` restores such a file,
or the port's own, into an embedder; by hand:

    arrays = load_jax_checkpoint("run.npz")
    state, weights = state_from_numpy(arrays, device="cuda", dtype=torch.float32)
    embedder.set_weights(weights)
    embedder.load_host_state(state)
"""

from __future__ import annotations

import numpy as np
import torch

from .core.state import EmbedState
from .utils import rng as rng_mod


def load_jax_checkpoint(path: str) -> dict[str, np.ndarray]:
    """The arrays of a checkpoint, flat or layered, of the JAX package or
    of the port."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {name: data[name] for name in data.files}


def state_from_numpy(
    arrays: dict, device: torch.device | str, dtype: torch.dtype
) -> tuple[EmbedState, np.ndarray]:
    """(EmbedState on ``device``, (n,) float64 weights) from checkpoint arrays."""
    device = torch.device(device)

    def tensor(name, dt):
        return torch.as_tensor(np.asarray(arrays[name]), dtype=dt, device=device)

    state = EmbedState(
        positions=tensor("positions", dtype),
        adam_m=tensor("adam_m", dtype),
        adam_v=tensor("adam_v", dtype),
        iteration=int(arrays["iteration"]),
        generator=rng_mod.new_generator(device),
        attract_loss=tensor("attract_loss", torch.float32),
        repel_loss=tensor("repel_loss", torch.float32),
        pos_change=tensor("pos_change", torch.float32),
        num_rep_forces=tensor("num_rep_forces", torch.int64),
        overflow=tensor("overflow", torch.int32),
    )
    return state, np.asarray(arrays["weights"], dtype=np.float64)
