"""The port's cell span layout (``kernels/span_compact.py``) against the JAX
package's, on the same inputs: the index skeleton and its capacity
protocol, the per-step structures and the compaction in f32, the forces
against the JAX dense oracle in f64 and against the Pallas sweep in
interpret mode, and the layout in the embedder: where it is chosen, growth
after truncation, checkpoints, the profiled step and the layered run."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import candidates as jax_candidates
from wembed_tpu.core import forces as jax_forces
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.kernels import span_compact as jax_cells

from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder
from wembed_tpu_torch.core import candidates
from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from wembed_tpu_torch.graphs import generators
from wembed_tpu_torch.kernels import span_compact, span_sparse, span_sweep
from wembed_tpu_torch.kernels.span_compact import CellIndex
from wembed_tpu_torch.kernels.span_sparse import SpanIndex
from wembed_tpu_torch.multilevel import LayeredEmbedder
from wembed_tpu_torch.utils import set_seed

torch.set_num_threads(1)

ST = span_sweep.ST
# an anisotropic cloud: the top eigenvalues stand apart, so both packages'
# 12 power iterations find the same three axes to ~1e-7
STRETCH = np.array([3.0, 2.0, 1.3, 0.8])


class Case:
    """One graph with weights and positions, as arrays for both packages,
    and both packages' cell indexes with the capacities the port's build
    measures at these positions (grown until nothing truncates, then
    resized to the needs, as the embedder's presize does)."""

    def __init__(self, n, d, *, additive=False, seed=7):
        g, _, _ = jax_generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(seed))
        self.g, self.n, self.d = g, g.num_vertices, d
        self.jopts = JaxOptions(embedding_dimension=d, additive_weights=additive)
        self.opts = EmbedderOptions(embedding_dimension=d, additive_weights=additive)
        self.w = jax_weights.initial_weights(g, self.jopts)
        self.inv_w = jax_weights.inv_exp_weights(self.w, d)
        pos = np.random.default_rng(1).normal(size=(self.n, d)) * 2.0 * STRETCH[:d]
        self.pos = pos.astype(np.float32)
        idx = CellIndex.build(self.w, self.opts, g.edge_src, g.col_idx)
        for _ in range(8):
            s = span_compact.build_cell_structures(*self.torch_args(), idx, self.opts)
            grown = idx.grow_from_needs(s.need.numpy())
            if int(s.overflow) == 0 or grown is None:
                break
            idx = grown
        self.idx = idx.resize_to_needs(s.need.numpy()) or idx
        self.jidx = jax_cells.CellIndex.build(self.w, self.jopts, g.edge_src, g.col_idx)._with_caps(self.idx.cap_t)

    def jax_args(self, dtype=jnp.float32):
        return (
            jnp.asarray(self.pos, dtype), jnp.asarray(self.inv_w, dtype),
            jnp.asarray(self.w, dtype), JaxDeviceGraph.build(self.g).colors,
        )

    def torch_args(self, dtype=torch.float32):
        return (
            torch.tensor(self.pos, dtype=dtype), torch.tensor(self.inv_w, dtype=dtype),
            torch.tensor(self.w, dtype=dtype), torch.tensor(self.g.colors),
        )


@functools.lru_cache(maxsize=None)
def case(n, d, additive=False):
    return Case(n, d, additive=additive)


# ------------------------------------------------------------------ index


INDEX_FIELDS = [
    "n", "d", "num_groups", "num_rows", "num_cells", "nb", "row_group", "row_sizes", "row_moff",
    "cell_row", "cell_group", "cell_sizes", "cell_moff", "bmaxpow", "group_of", "class_bm2",
    "row_of_sorted1", "cell_of_sorted2", "cell_moff_of_sorted", "sorted_shift_q",
    "blk_first", "blk_last",
]


@pytest.mark.parametrize("n,d", [(3000, 3), (5000, 4)])
def test_index_build_matches_jax(n, d):
    g, _, _ = jax_generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(7))
    jopts, opts = JaxOptions(embedding_dimension=d), EmbedderOptions(embedding_dimension=d)
    w = jax_weights.initial_weights(g, jopts)
    idx = CellIndex.build(w, opts, g.edge_src, g.col_idx)
    jidx = jax_cells.CellIndex.build(w, jopts, g.edge_src, g.col_idx)
    assert idx.num_cells > idx.num_rows > 1
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(idx, name), getattr(jidx, name), err_msg=name)
    np.testing.assert_array_equal(idx.cap_t, jidx.cap_t)
    assert idx.w == jidx.w
    # the port has no dummy query block and no padded edge list
    np.testing.assert_array_equal(idx.src_of_q, jidx.src_of_q[: idx.nq])
    assert (jidx.src_of_q[idx.nq :] == idx.n).all()
    e = g.num_directed_edges
    np.testing.assert_array_equal(idx.edge_src, jidx.edge_src[:e])
    np.testing.assert_array_equal(idx.edge_dst, jidx.edge_dst[:e])
    np.testing.assert_array_equal(np.sqrt(idx.edge_bm2).astype(np.float32), jidx.edge_bmaxpow[:e])
    # the sweep's view: one row of capacity tiles
    items = idx.work_items(torch.device("cpu"))
    assert idx.blk_t_tensor(torch.device("cpu")).shape == (idx.nb, 1)
    assert int(items[:, 3].sum()) == idx.w and (items[:, 1] == 0).all()


@pytest.mark.parametrize(
    "method,kw,with_needs",
    [("grow_from_needs", {}, True), ("grow_from_needs", dict(headroom=1.5), True),
     ("resize_to_needs", {}, True), ("shrink_to_needs", {}, True), ("grow_all", {}, False),
     ("grow_all", {}, True)],
)
def test_capacity_protocol_matches_jax(method, kw, with_needs):
    """Capacities decide truncation and the sweep's work items, so every
    rule gives the JAX package's capacities for the same needs."""
    c = case(3000, 3)
    rng = np.random.default_rng(len(method) + len(kw) + with_needs)
    nb = c.idx.nb
    caps = rng.integers(0, 40, size=nb) * (rng.random(nb) < 0.8)
    needs = rng.choice([0, 1, 255, 256, 700, 3000, 20000], size=nb)
    idx, jidx = c.idx._with_caps(caps), c.jidx._with_caps(caps)
    args = (needs,) if with_needs else ()
    got = getattr(idx, method)(*args, **kw)
    want = getattr(jidx, method)(*args, **kw)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.cap_t, want.cap_t)
    assert got.w == want.w and got.can_grow() == want.can_grow()
    assert got._tensors is idx._tensors  # resized indexes share the device tables


# ------------------------------------------------------------- structures


def test_third_axis_extends_the_first_two():
    """``_principal_axes3``'s v1 and v2 are ``_principal_axes2``'s, bit for
    bit; all three agree with the JAX package's axes."""
    c = case(3000, 4)
    p = torch.tensor(c.pos)
    centred = p - p.mean(0)
    v3 = candidates._principal_axes3(centred)
    v2 = candidates._principal_axes2(centred)
    assert torch.equal(v3[0], v2[0]) and torch.equal(v3[1], v2[1])
    pj = jnp.asarray(c.pos)
    for a, b in zip(v3, jax_candidates._principal_axes3(pj - jnp.mean(pj, axis=0))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("d,starved", [(3, False), (4, False), (3, True)])
def test_structures_match_jax(d, starved):
    """In f32 on both sides: needs, overflow, the inverse maps, each
    (block, cell) window and prefix, and the compacted members of every
    block, in the JAX package's order (cell-major, z ascending) and cut
    where it cuts them.  Starved capacities of one tile truncate."""
    c = case(3000, d)
    idx, jidx = c.idx, c.jidx
    if starved:
        idx, jidx = idx._with_caps(np.minimum(idx.cap_t, 1)), jidx._with_caps(np.minimum(idx.cap_t, 1))
    s_t = span_compact.build_cell_structures(*c.torch_args(), idx, c.opts)
    s_j = jax_cells.build_cell_structures(*c.jax_args(), jidx, c.jopts)
    np.testing.assert_array_equal(s_t.need.numpy(), np.asarray(s_j.need))
    assert int(s_t.overflow) == int(s_j.overflow)
    assert (int(s_t.overflow) > 0) == starved
    for name in ("rank_of", "block_of", "slot_of", "row_of"):
        np.testing.assert_array_equal(getattr(s_t, name).numpy(), np.asarray(getattr(s_j, name)), err_msg=name)
    cov = np.asarray(s_j.covtab)
    for k, name in enumerate(("start", "stop", "prefix")):
        np.testing.assert_array_equal(getattr(s_t, name).numpy().reshape(-1), cov[:, k], err_msg=name)
    np.testing.assert_array_equal(np.repeat(s_t.blk_t[:, 0].numpy() * ST, idx.num_cells), cov[:, 3])
    # the compact members: the JAX channels [pos(d), invw, bm2, 1, 1/invw] in
    # the port's row-major [pos(d), invw, bm2, 1/invw]; dead slots carry the
    # sentinel in both
    nca = idx.w * ST
    assert s_t.srec.shape == (nca, d + 3)
    sdata = np.asarray(s_j.sdata).T[:nca]
    np.testing.assert_array_equal(s_t.srec.numpy(), sdata[:, [*range(d + 2), d + 3]])
    np.testing.assert_array_equal(s_t.scol.numpy(), np.asarray(s_j.scol)[0, :nca])
    # the queries (lw from each package's own f32 pow: up to 3 ulp in lw^2)
    nq = idx.nq
    qdata = np.asarray(s_j.qdata).reshape(-1, s_j.qdata.shape[-1])[:nq]
    np.testing.assert_allclose(s_t.qrec.numpy(), qdata[:, : d + 3], rtol=3.6e-7)
    np.testing.assert_array_equal(s_t.qcol.numpy(), np.asarray(s_j.qcol).reshape(-1)[:nq])
    np.testing.assert_array_equal(s_t.start_tile[:, 0].numpy(), np.cumsum(idx.cap_t) - idx.cap_t)


# ----------------------------------------------------------------- forces


def _jax_dense_f64(c: Case):
    dg = JaxDeviceGraph.build(c.g)
    return jax_forces.dense_repulsion_forces(
        jnp.asarray(c.pos, jnp.float64), jnp.asarray(c.inv_w), jax_forces.build_dense_adjacency(dg),
        dg.colors, c.jopts,
    )


@pytest.mark.parametrize("d,additive", [(3, False), (4, False), (3, True), (2, False)])
def test_cell_repulsion_matches_the_dense_oracle(d, additive):
    """With no block truncated the cells sweep plus the correction gives
    the dense path's repulsion: within the JAX package's own tolerances
    (tests/test_kernels.py:654-679), the port in f64 against the jnp dense
    oracle in f64.  At d = 2 the third axis is the guarded degenerate one,
    and the windows still cover every candidate."""
    c = case(1500, d, additive)
    assert c.idx.num_cells > c.idx.num_rows > 1
    f, loss, cnt, ovf, zc = span_compact.cell_repulsion_forces(
        *c.torch_args(torch.float64), c.idx, c.opts
    )
    fd, lossd, cntd, zcd = _jax_dense_f64(c)
    assert int(ovf) == 0
    scale = float(jnp.max(jnp.abs(fd))) + 1e-30
    np.testing.assert_allclose(f.numpy() / scale, np.asarray(fd) / scale, atol=5e-5)
    np.testing.assert_allclose(float(loss), float(lossd), rtol=2e-4)
    np.testing.assert_array_equal(zc.numpy(), np.asarray(zcd))
    assert int(cnt) >= int(cntd) > 0


def test_cell_forces_match_the_pallas_sweep():
    """The port's plain sweep over the compact members against the JAX
    cell path with its Pallas kernel in interpret mode, both in f32: the
    repulsion pass, and the fused pass at positions with no coincident
    edge (the packages draw their kicks from different generators)."""
    c = case(1500, 4)
    j_args, t_args = c.jax_args(), c.torch_args()
    before = span_sweep.span_sweep.launches
    r_t = span_compact.cell_repulsion_forces(*t_args, c.idx, c.opts)
    r_j = jax_cells.cell_repulsion_forces(*j_args, c.jidx, c.jopts, interpret=True)
    assert int(r_t[3]) == int(r_j[3]) == 0
    assert int(r_t[2]) == int(r_j[2]) > 0
    np.testing.assert_array_equal(r_t[4].numpy(), np.asarray(r_j[4]))
    scale = float(np.abs(np.asarray(r_j[0])).max())
    np.testing.assert_allclose(r_t[0].numpy() / scale, np.asarray(r_j[0]) / scale, atol=5e-5)
    np.testing.assert_allclose(float(r_t[1]), float(r_j[1]), rtol=2e-4)

    src, dst = c.g.edge_src, c.g.col_idx
    assert not np.all(c.pos[src] == c.pos[dst], axis=1).any()
    gen = torch.Generator().manual_seed(3)
    f_t, att_t, rep_t, cnt_t, ovf_t, zc_t = span_compact.cell_fused_forces(*t_args, c.idx, c.opts, gen)
    f_j, att_j, rep_j, cnt_j, ovf_j, zc_j = jax_cells.cell_fused_forces(
        *j_args, c.jidx, c.jopts, jax.random.PRNGKey(3), interpret=True
    )
    assert int(ovf_t) == int(ovf_j) == 0
    assert int(cnt_t) == int(cnt_j) == int(r_j[2])
    np.testing.assert_array_equal(zc_t.numpy(), np.asarray(zc_j))
    scale = float(np.abs(np.asarray(f_j)).max())
    np.testing.assert_allclose(f_t.numpy() / scale, np.asarray(f_j) / scale, atol=5e-5)
    np.testing.assert_allclose(float(att_t), float(att_j), rtol=1e-5)
    np.testing.assert_allclose(float(rep_t), float(rep_j), rtol=2e-4)
    assert span_sweep.span_sweep.launches == before  # CPU tensors run the plain sweep


def test_cells_count_what_the_windows_count():
    """Both layouts count the same per-class candidate set when nothing
    truncates; only which members each block visits differs."""
    c = case(1500, 3)
    args = c.torch_args(torch.float64)
    f_c, l_c, cnt_c, ovf_c, z_c = span_compact.cell_repulsion_forces(*args, c.idx, c.opts)
    si = SpanIndex.build(c.w, c.opts, c.g.edge_src, c.g.col_idx, span_scale=8.0)
    for _ in range(8):
        s = si.structures(*args, c.opts)
        grown = si.grow_from_needs(s.need.numpy())
        if int(s.overflow) == 0 or grown is None:
            break
        si = grown
    f_s, l_s, cnt_s, ovf_s, z_s = span_sparse.span_repulsion_forces(*args, si, c.opts)
    assert int(ovf_c) == int(ovf_s) == 0
    assert int(cnt_c) == int(cnt_s) > 0
    assert torch.equal(z_c, z_s)
    scale = float(f_s.abs().max())
    np.testing.assert_allclose(f_c.numpy(), f_s.numpy(), rtol=1e-9, atol=1e-9 * scale)
    np.testing.assert_allclose(float(l_c), float(l_s), rtol=1e-9)


def test_truncation_surfaces_and_growth_recovers():
    """As tests/test_kernels.py:718: capacities of one tile truncate, which
    shows as overflow and fewer candidates (the correction takes back only
    pairs the cut sweep counted, so forces stay finite); growth from the
    measured needs recovers the untruncated forces."""
    c = case(1500, 3)
    args = c.torch_args(torch.float64)
    full = span_compact.cell_repulsion_forces(*args, c.idx, c.opts)
    starved = c.idx._with_caps(np.minimum(c.idx.cap_t, 1))
    cut = span_compact.cell_repulsion_forces(*args, starved, c.opts)
    assert int(cut[3]) > 0 and int(cut[2]) < int(full[2])
    assert torch.isfinite(cut[0]).all()
    regrown, events = starved, 0
    while True:
        s = regrown.structures(*args, c.opts)
        if int(s.overflow) == 0:
            break
        regrown = regrown.grow_from_needs(s.need.numpy())
        events += 1
    assert events == 1  # each starved block grows past its measured need at once
    again = span_compact.cell_repulsion_forces(*args, regrown, c.opts, structures=s)
    assert int(again[3]) == 0 and int(again[2]) == int(full[2])
    scale = float(full[0].abs().max())
    np.testing.assert_allclose(again[0].numpy(), full[0].numpy(), rtol=1e-9, atol=1e-9 * scale)


# --------------------------------------------------------------- embedder


def _girg(n=1200, d=3, seed=4):
    return generators.girg(n, dim=d, avg_degree=10, ple=2.4, rng=np.random.default_rng(seed))[0]


CELLS = dict(embedding_dimension=3, repulsion_mode=RepulsionMode.BUCKET, span_layout="cells")


@pytest.mark.parametrize(
    "options,layout",
    [
        (CELLS, "cells"),
        (dict(CELLS, dtype="float64"), "windows"),
        (dict(CELLS, index_size=0.5), "windows"),
        (dict(CELLS, span_layout="auto"), "windows"),
        (dict(CELLS, span_layout="windows"), "windows"),
        (dict(CELLS, num_negative_samples=3), None),
        (dict(CELLS, repulsion_mode=RepulsionMode.DENSE), None),
    ],
)
def test_layout_is_chosen_where_the_jax_package_chooses_it(options, layout):
    """Cells only for span_layout="cells" on the fused span kernel's path
    (f32, a whole index, no negative sampling); f64 and a partial index
    take the windows, the counterpart of the JAX package's BucketIndex."""
    opts = EmbedderOptions(**options)
    emb = WEmbedEmbedder(_girg(300), opts, verbose=False, device="cpu")
    assert emb.span_layout == layout
    assert isinstance(emb._index, {"cells": CellIndex, "windows": SpanIndex, None: type(None)}[layout])
    if layout is not None:
        assert opts.resolve_span_layout() == layout


@pytest.mark.parametrize("backend", ["replicated", "halo"])
def test_multi_device_embedders_keep_the_windows(backend):
    from wembed_tpu_torch.distributed import HaloEmbedder, MultiChipEmbedder

    cls = HaloEmbedder if backend == "halo" else MultiChipEmbedder
    emb = cls(_girg(300), EmbedderOptions(**CELLS), verbose=False, device="cpu")
    assert emb.span_layout == "windows" and isinstance(emb._index, SpanIndex)
    emb.calculate_step()
    assert int(emb.state.overflow) == 0


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="unknown span_layout"):
        WEmbedEmbedder(_girg(300), EmbedderOptions(**dict(CELLS, span_layout="grid")), verbose=False,
                       device="cpu")


def test_cells_embedder_grows_and_resumes_bitwise(tmp_path):
    """A cells run on the CPU, its capacities presized and grown by the
    growth protocol, cut at iteration 8 (inside a resize segment of 5) and
    checkpointed; a fresh embedder from another seed loads the file
    (capacities and the open segment's growth count included) and its 8
    further steps end bitwise equal to 16 straight steps."""
    g = _girg()
    opts = EmbedderOptions(**CELLS, max_iterations=16, span_resize_interval=5, window_capacity=4)
    set_seed(1)
    straight = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    assert straight.span_layout == "cells"
    straight.calculate_embedding()
    set_seed(1)
    saved = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    saved.calculate_embedding(max_iterations=8)
    ckpt = str(tmp_path / "cells.npz")
    save_checkpoint(ckpt, saved)
    set_seed(2)
    resumed = WEmbedEmbedder(g, opts, verbose=False, device="cpu")
    load_checkpoint(ckpt, resumed)
    np.testing.assert_array_equal(resumed._index.cap_t, saved._index.cap_t)
    assert resumed._segment_growth == saved._segment_growth
    resumed.calculate_embedding()
    assert resumed.iteration == straight.iteration == 16
    np.testing.assert_array_equal(resumed.get_coordinates(), straight.get_coordinates())
    for name in ("adam_m", "adam_v", "attract_loss", "repel_loss", "num_rep_forces", "overflow"):
        assert torch.equal(getattr(resumed.state, name), getattr(straight.state, name)), name
    np.testing.assert_array_equal(resumed._index.cap_t, straight._index.cap_t)
    assert straight.growth_events > 0 and resumed.growth_events == straight.growth_events
    assert straight.final_overflow == 0 and np.isfinite(straight.get_coordinates()).all()


def test_profiled_cells_step_matches_the_normal_step():
    """The profiled step's ``index`` phase is the cell build and its
    repulsion the cells sweep with the correction: after the first step
    the same counts and the positions equal up to the order of the force
    sums (f32; the profiled step adds attraction and repulsion apart)."""
    g = _girg()
    coords = np.random.default_rng(5).normal(size=(g.num_vertices, 3)) * 4.0
    runs = []
    for profile in (False, True):
        set_seed(9)
        emb = WEmbedEmbedder(g, EmbedderOptions(**CELLS), initial_coordinates=coords, verbose=False,
                             profile=profile, device="cpu")
        emb.calculate_step()
        runs.append(emb)
    normal, profiled = runs
    assert profiled.span_layout == "cells"
    want = normal.get_coordinates()
    np.testing.assert_allclose(profiled.get_coordinates(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    assert int(profiled.state.num_rep_forces) == int(normal.state.num_rep_forces) > 0
    assert int(profiled.state.overflow) == int(normal.state.overflow) == 0
    np.testing.assert_allclose(float(profiled.state.repel_loss), float(normal.state.repel_loss), rtol=1e-5)
    assert [t.display_name for t in profiled.get_timings()][0] == "index"


def test_layered_span_layers_use_cells():
    """``span_layout`` reaches every layer's embedder: with a low dense
    threshold the finer layers run the span path in the cell layout and
    the layered run ends with finite positions and no truncation."""
    g = _girg(600)
    opts = EmbedderOptions(**dict(CELLS, repulsion_mode=RepulsionMode.AUTO), dense_threshold=100,
                           max_iterations=6)
    set_seed(3)
    layouts = []

    def factory(graph, opts, **kw):
        emb = WEmbedEmbedder(graph, opts, **kw)
        layouts.append((graph.num_vertices, emb.span_layout))
        return emb

    emb = LayeredEmbedder(g, opts, verbose=False, device="cpu", embedder_factory=factory)
    emb.calculate_embedding()
    assert [r.path for r in emb.layer_records][-1] == "span"
    assert all((lay == "cells") == (n > 100) for n, lay in layouts)
    assert sum(lay == "cells" for _, lay in layouts) >= 2
    assert np.isfinite(emb.get_coordinates()).all()
    assert emb.layer_records[-1].final_overflow == 0
