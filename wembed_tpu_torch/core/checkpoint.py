"""Checkpoint / resume of the full embedding state.

Counterpart of ``wembed_tpu/core/checkpoint.py``.  The reference's resume
path loses optimizer state: only coordinates round-trip through CSV
(reference src/cli_wembed/main.cpp:22-26, include/wembed.h:157-162), and its
LayeredEmbedder cannot resume at all (LayeredEmbedder.cpp:26-36).  Here the
whole state (positions, Adam moments, iteration, losses, counters), the
weights and the generator's state go to one ``.npz`` with the JAX package's
keys, so a resumed run continues bit for bit; a layered checkpoint adds the
layer, the accumulated iteration count and the parent pointers of every
layer, so a multilevel run resumes mid-hierarchy.

What the port's file holds beyond the JAX package's keys:
  * ``generator_state`` (uint8, ``torch.Generator.get_state()``) and
    ``generator_device``.  The state restores only on the device type that
    saved it (a CUDA generator's state is a seed and an offset, a CPU one
    a Mersenne twister); on the other type, and for a JAX file, the state
    draws a fresh generator from the host seed stream (``convert.py``).
  * ``host_rng``: the host seed stream's state, restored on load, so that
    what is drawn after the resume (the expansion and the generators of
    the layers after a layered checkpoint's) is what the saved run draws.
  * On the span path, the windows (``SpanIndex.blk_t``) and the growth
    protocol's counters.  The JAX package re-presizes windows from the
    restored positions: in its sweep, wider windows only add exact zeros.
    In the port they would not: the sweep's work items (at most
    ``WORK_ITEM_TILES`` tiles, ``kernels/span_sweep.py:work_items``) group
    each slot's partial sums by item, so other windows give other f32 sums.
    So the saved windows are reinstalled whenever the skeleton built from
    the saved weights has their shape, and only a file without them (a JAX
    checkpoint) presizes.

``key`` holds the data of a JAX PRNG key derived from the generator's seed
and ``span_scale`` is 1, so the JAX package's ``load_checkpoint`` reads the
port's files too.  CSV import and export for reference interop live in
``graphs.io`` (``write_coordinates`` / ``read_coordinates``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import convert
from ..multilevel.hierarchy import GraphHierarchy
from ..utils import rng as rng_mod


def _flat_arrays(embedder) -> dict:
    s = embedder.state
    gen = s.generator

    def host(t):
        return t.detach().cpu().numpy()

    arrays = dict(
        positions=host(s.positions),
        adam_m=host(s.adam_m),
        adam_v=host(s.adam_v),
        iteration=np.asarray(s.iteration, np.int32),
        key=np.asarray([0, gen.initial_seed() & 0xFFFFFFFF], np.uint32),
        attract_loss=host(s.attract_loss),
        repel_loss=host(s.repel_loss),
        pos_change=host(s.pos_change),
        num_rep_forces=host(s.num_rep_forces),
        overflow=host(s.overflow),
        weights=embedder.get_weights(),
        span_scale=np.asarray(1.0),
        generator_state=gen.get_state().numpy(),
        generator_device=np.asarray(gen.device.type),
        host_rng=np.asarray(json.dumps(rng_mod.host_rng().bit_generator.state)),
    )
    if embedder._index is not None:
        arrays.update(
            blk_t=embedder._index.blk_t,
            growth_events=np.asarray(embedder._growth_events),
            shrink_events=np.asarray(embedder._shrink_events),
            spurious_resumes=np.asarray(embedder._spurious_resumes),
        )
    return arrays


def save_checkpoint(path: str, embedder) -> None:
    """Snapshot a ``WEmbedEmbedder`` or ``LayeredEmbedder`` to ``path``
    (.npz, appended when missing)."""
    if hasattr(embedder, "hierarchy"):  # LayeredEmbedder
        arrays = _flat_arrays(embedder._current)
        arrays["layered"] = np.asarray(1)
        arrays["current_layer"] = np.asarray(embedder.current_layer)
        arrays["current_iteration"] = np.asarray(embedder.current_iteration)
        arrays["num_layers"] = np.asarray(embedder.hierarchy.num_layers)
        for i, layer in enumerate(embedder.hierarchy.layers[:-1]):
            arrays[f"parent_{i}"] = layer.parent
        np.savez(path, **arrays)
        return
    np.savez(path, **_flat_arrays(embedder))


def _restore_flat(arrays: dict, embedder) -> None:
    n = embedder.graph.num_vertices
    if arrays["positions"].shape[0] != n:
        raise ValueError(
            f"checkpoint has {arrays['positions'].shape[0]} vertices, embedder graph has {n}"
        )
    state, weights = convert.state_from_numpy(arrays, embedder.device, embedder._dtype)
    if "generator_state" in arrays and str(arrays["generator_device"]) == embedder.device.type:
        state.generator.set_state(torch.as_tensor(arrays["generator_state"]))
    # the weights first: on the span path they rebuild the skeleton
    embedder._set_weights_internal(weights)
    embedder.state = state
    if embedder._index is None:
        return
    saved = arrays.get("blk_t")
    if saved is not None and saved.shape == embedder._index.blk_t.shape:
        embedder._swap_index(embedder._index._with_blk_t(saved))
        embedder._growth_events = int(arrays["growth_events"])
        embedder._shrink_events = int(arrays["shrink_events"])
        embedder._spurious_resumes = int(arrays["spurious_resumes"])
    else:
        embedder._presize_spans()


def load_checkpoint(path: str, embedder) -> None:
    """Restore a checkpoint of the port or of the JAX package into an
    embedder built on the same graph and options.

    Flat checkpoints restore into a ``WEmbedEmbedder``; layered ones into a
    ``LayeredEmbedder`` on the same finest graph, whose hierarchy is rebuilt
    from the saved parent pointers with ``coarsen_graph``, not coarsened
    again, so it is the saved one whatever seed built the embedder."""
    arrays = convert.load_jax_checkpoint(path)
    if "layered" in arrays:
        _restore_layered(arrays, embedder)
    else:
        if hasattr(embedder, "hierarchy"):
            raise ValueError("a flat checkpoint restores into a WEmbedEmbedder")
        _restore_flat(arrays, embedder)
    if "host_rng" in arrays:
        rng_mod.host_rng().bit_generator.state = json.loads(str(arrays["host_rng"]))


def _restore_layered(arrays: dict, embedder) -> None:
    if not hasattr(embedder, "hierarchy"):
        raise ValueError("a layered checkpoint restores into a LayeredEmbedder")
    hierarchy = GraphHierarchy.from_parents(
        embedder.graph, [arrays[f"parent_{i}"] for i in range(int(arrays["num_layers"]) - 1)]
    )
    embedder.restore_layer(
        hierarchy,
        int(arrays["current_layer"]),
        int(arrays["current_iteration"]),
        arrays["positions"],
        arrays["weights"],
    )
    _restore_flat(arrays, embedder._current)
