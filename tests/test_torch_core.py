"""The port's numpy and elementwise modules against the JAX package's, on
the same inputs: optimizers, gravity, the displacement metric, weights,
edge-list reading and the coordinate CSV."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wembed_tpu.core import forces as jax_forces
from wembed_tpu.core import optim as jax_optim
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.options import EmbedderOptions as JaxOptions
from wembed_tpu.core.options import WeightType as JaxWeightType
from wembed_tpu.graphs import io as jax_io

from wembed_tpu_torch.core import forces, optim, weights
from wembed_tpu_torch.core.options import EmbedderOptions, WeightType
from wembed_tpu_torch.graphs import io

torch.set_num_threads(1)


def _arrays(seed, shape, count):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(count)]


@pytest.mark.parametrize("t", [1, 7])
def test_adam_update_matches_jax(t):
    params, grads, m, v = _arrays(0, (50, 3), 4)
    v = np.abs(v)
    hp = (10.0, 0.99)
    want = jax_optim.adam_update(
        jnp.asarray(params), jnp.asarray(grads), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(t, jnp.int32), jax_optim.AdamParams(*hp),
    )
    got = optim.adam_update(
        *(torch.from_numpy(a) for a in (params, grads, m, v)), t, optim.AdamParams(*hp)
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_simple_update_matches_jax():
    params, grads = _arrays(1, (50, 2), 2)
    grads = 3.0 * grads  # some coordinates beyond the clip at 1
    want = jax_optim.simple_update(
        jnp.asarray(params), jnp.asarray(grads), jnp.asarray(5, jnp.int32), 10.0, 0.99
    )
    got = optim.simple_update(torch.from_numpy(params), torch.from_numpy(grads), 5, 10.0, 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_gravity_and_displacement_match_jax():
    old, new = _arrays(2, (200, 4), 2)
    new = old + 1e-2 * new
    np.testing.assert_allclose(
        forces.apply_gravity_centre(torch.from_numpy(new)).numpy(),
        np.asarray(jax_forces.apply_gravity_centre(jnp.asarray(new))),
        rtol=1e-12, atol=1e-14,
    )
    got = forces.mean_squared_displacement(torch.from_numpy(old), torch.from_numpy(new))
    want = jax_forces.mean_squared_displacement(jnp.asarray(old), jnp.asarray(new))
    assert got.dtype == torch.float32
    # both reduce in f32, in different orders
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("unit,hint,dim", [(False, -1.0, 2), (False, 3.0, 4), (True, -1.0, 3)])
def test_weights_match_jax(unit, hint, dim):
    g_t = io.read_edge_list("assets/small_graph.edg")
    g_j = jax_io.read_edge_list("assets/small_graph.edg")
    opts_t = EmbedderOptions(
        embedding_dimension=dim, dimension_hint=hint,
        weight_type=WeightType.UNIT if unit else WeightType.DEGREE,
    )
    opts_j = JaxOptions(
        embedding_dimension=dim, dimension_hint=hint,
        weight_type=JaxWeightType.UNIT if unit else JaxWeightType.DEGREE,
    )
    w_t = weights.initial_weights(g_t, opts_t)
    np.testing.assert_array_equal(w_t, jax_weights.initial_weights(g_j, opts_j))
    np.testing.assert_array_equal(
        weights.inv_exp_weights(w_t, dim), jax_weights.inv_exp_weights(w_t, dim)
    )


@pytest.mark.parametrize("path", ["assets/small_graph.edg", "assets/girg10k.edg"])
def test_read_edge_list_matches_jax(path):
    g_t, g_j = io.read_edge_list(path), jax_io.read_edge_list(path)
    for name in ("row_ptr", "col_idx", "colors"):
        a, b = getattr(g_t, name), getattr(g_j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_weights", [False, True])
def test_coordinates_round_trip(tmp_path, with_weights):
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(17, 3)) * 1e3
    w = rng.uniform(0.5, 2.0, 17) if with_weights else None
    path = str(tmp_path / "emb.csv")
    io.write_coordinates(path, pos, w)
    back = io.read_coordinates(path)
    want = pos if w is None else np.concatenate([pos, w[:, None]], axis=1)
    np.testing.assert_array_equal(back, want)
    # byte-compatible with the JAX package's writer
    jax_path = str(tmp_path / "emb_jax.csv")
    jax_io.write_coordinates(jax_path, pos, w)
    assert open(path).read() == open(jax_path).read()
