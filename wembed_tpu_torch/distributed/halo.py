"""The vertex-sharded halo backend: each rank holds its range of the state.

Counterpart of ``wembed_tpu/distributed/halo.py`` (``HaloPlan``,
``build_halo_step``, ``HaloEmbedder``; the scale-out design of SURVEY.md
§5.8, which the reference, OpenMP only, does not have).  One process a rank
(``distributed/mesh.py``), P ranks:

  * The STATE is sharded by vertex range: rank p holds rows [p R, p R + R)
    of the positions and of both Adam moments, R = ceil(n / P), padded to
    n_pad = R P rows; padded rows stay at 0.  Weights, inverse weights,
    colours and the generator are replicated.
  * Each rank owns the directed edges of its source range (CSR order makes
    them one slice) and the halo: the rows of other ranks that its edges
    reach, sent through static lists (``HaloPlan``).
  * A step, in the JAX package's order:
      1. one ``all_to_all`` of the boundary positions (the halo), then
         attraction over the rank's own edges, into its own rows only;
      2. an ``all_gather`` of the positions, then the rank's share of the
         repulsion pass (``core/step.py:Share``):
           - dense: rows ``Share.cut(n)`` of ``csrc/fused_dense.cu`` with
             the attraction scale at 0 (the profiled step's form), which
             are exactly the rank's own rows;
           - span: the replicated structures build, the sweep of a slice
             of the work items (``csrc/span_sweep.cu``), and the neighbour
             correction over the rank's chunk of ceil(E / P) directed
             edges, the only correction edges it holds (the JAX package's
             ``EdgeChunk``); with ``halo_resident_structures`` the sweep
             takes the rank's range of query blocks instead (below);
           - sampled: rows ``Share.cut(n)`` of the candidate pass;
      3. the span pass's partial forces and coincident counts go back to
         the vertex ranges in one ``reduce_scatter``; the dense and sampled
         passes computed the rank's own rows, so they need none;
      4. the kicks, the centre force and the optimizer on the rank's rows
         (``core/step.py:_apply_forces``); one all-reduce, packed in f64, of
         the losses, the candidate count and the rows' sums that gravity
         (the global mean) and the displacement metric need.  The
         overflow comes from the structures, which every rank builds
         whole, so it is the same on every rank and needs no collective.
    So a step makes three collectives on the dense and sampled paths and
    four on the span path.
  * The generator's stream is the single-device step's
    (``core/step.py``): the partial index's member key, the edge kicks
    ((E, d), drawn whole and sliced at the rank's first edge; on the dense
    path too, as the JAX halo step and the profiled dense step draw them),
    the negative samples, the vertex kicks ((n, d), sliced to the rank's
    rows).  Every draw is whole on every rank.

Resident mode (``EmbedderOptions.halo_resident_structures``): rank p sweeps
the query blocks ``Share.cut(nb)``, ceil(nb / P) of them (the port has no
dummy block), through the items of those blocks, which are one slice of
the block-major item table (``kernels/span_sparse.py:block_items``).  The
sweep is the item-slice sweep of the other mode; only the slice's bounds
differ.  The JAX package's compact per-work-tile member buffer and its
per-device tile budget (with the "partition overflow") are TPU layouts the
port leaves out (ROADMAP, "TPU workarounds not to port"), so the port's
partition overflow is always 0.

Every rank calls every method, in the same order (one program, many
ranks); every host decision (convergence, growth) reads values that are
the same on every rank.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core import edge_geometry as edges
from ..core import forces
from ..core import step as step_mod
from ..core.options import EmbedderOptions
from ..core.state import EmbedState
from ..graphs.csr import CSRGraph
from ..kernels.fused_dense import fused_dense_forces
from ..kernels.span_sparse import SpanIndex, block_items, build_span_structures, span_repulsion_forces
from ..utils.timer import Timer
from .mesh import Mesh, make_mesh
from .step import MultiChipEmbedder


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class HaloPlan:
    """Static partition of the vertices and directed edges over P ranks
    (``wembed_tpu/distributed/halo.py:HaloPlan``, array for array).

    Vertex v belongs to rank v // R (R = n_pad / P).  Edge arrays are
    stacked (P, E_s); rank p's ``ext`` index space is its R local rows
    followed by P blocks of H received halo rows (block q: the rows of rank
    q that p's edges reach)."""

    n: int
    n_pad: int
    R: int
    P: int
    H: int  # halo rows exchanged per (owner, requester) pair
    E_s: int  # padded directed-edge count per rank
    edge_src_local: np.ndarray  # (P, E_s) int32, src - p*R
    edge_dst_ext: np.ndarray  # (P, E_s) int32 index into the ext table
    edge_dst_global: np.ndarray  # (P, E_s) int32
    edge_mask: np.ndarray  # (P, E_s) bool
    send_idx: np.ndarray  # (P, P, H) int32: [owner, requester] -> owner's local rows
    local_row_ptr: np.ndarray  # (P, R+1) int32 CSR offsets into the rank's edge slice
    edge_goff: np.ndarray  # (P, 1) int32 global index of each rank's first directed edge

    @staticmethod
    def build(graph: CSRGraph, num_shards: int) -> "HaloPlan":
        n = graph.num_vertices
        Pn = num_shards
        R = _round_up(max(n, Pn), Pn) // Pn
        n_pad = R * Pn
        src = graph.edge_src  # nondecreasing (CSR)
        dst = graph.col_idx
        bounds = np.searchsorted(src, np.arange(Pn + 1) * R)
        E_s = max(256, _round_up(int(np.max(bounds[1:] - bounds[:-1])), 256))

        halo_lists = []  # [p][q] sorted unique dst ids owned by q, needed by p
        for p in range(Pn):
            d_p = np.unique(dst[bounds[p] : bounds[p + 1]])
            owners = d_p // R
            halo_lists.append([d_p[owners == q] for q in range(Pn)])
        H = max(
            8,
            _round_up(
                max(
                    (h.shape[0] for p in range(Pn) for q, h in enumerate(halo_lists[p]) if q != p),
                    default=1,
                ),
                8,
            ),
        )

        esrc_l = np.zeros((Pn, E_s), np.int32)
        edst_ext = np.zeros((Pn, E_s), np.int32)
        edst_g = np.zeros((Pn, E_s), np.int32)
        emask = np.zeros((Pn, E_s), bool)
        send_idx = np.zeros((Pn, Pn, H), np.int32)
        local_row_ptr = np.zeros((Pn, R + 1), np.int32)
        for p in range(Pn):
            lo, hi = bounds[p], bounds[p + 1]
            k = hi - lo
            esrc_l[p, :k] = src[lo:hi] - p * R
            local_row_ptr[p] = np.searchsorted(esrc_l[p, :k], np.arange(R + 1))
            edst_g[p, :k] = dst[lo:hi]
            emask[p, :k] = True
            ext = np.zeros(k, np.int64)
            d_slice = dst[lo:hi]
            owners = d_slice // R
            own = owners == p
            ext[own] = d_slice[own] - p * R
            for q in range(Pn):
                if q == p:
                    continue
                hq = halo_lists[p][q]
                if hq.shape[0] > H:
                    raise AssertionError("halo capacity miscomputed")
                send_idx[q, p, : hq.shape[0]] = hq - q * R
                sel = owners == q
                ext[sel] = R + q * H + np.searchsorted(hq, d_slice[sel])
            edst_ext[p, :k] = ext
        return HaloPlan(
            n=n, n_pad=n_pad, R=R, P=Pn, H=H, E_s=E_s,
            edge_src_local=esrc_l, edge_dst_ext=edst_ext,
            edge_dst_global=edst_g, edge_mask=emask, send_idx=send_idx,
            local_row_ptr=local_row_ptr,
            edge_goff=bounds[:-1].astype(np.int32).reshape(Pn, 1),
        )


@dataclass(frozen=True)
class _RankPlan:
    """One rank's share of the plan on its device: its R rows, its own
    directed edges (unpadded) and its halo send lists."""

    r0: int  # first global row
    rows: int  # real rows, R or fewer on the last ranks
    edge_lo: int  # global index of the first own directed edge
    esrc: torch.Tensor  # (k,) i64 local source rows
    edst_ext: torch.Tensor  # (k,) i64 rows of the ext table
    edst: torch.Tensor  # (k,) i64 global destinations
    row_ptr: torch.Tensor  # (R+1,) i64 segment offsets
    send_idx: torch.Tensor  # (P, H) i64 local rows to send to each rank

    @staticmethod
    def build(plan: HaloPlan, rank: int, device: torch.device) -> "_RankPlan":
        k = int(plan.edge_mask[rank].sum())

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        r0 = rank * plan.R
        return _RankPlan(
            r0=r0, rows=max(0, min(plan.n - r0, plan.R)), edge_lo=int(plan.edge_goff[rank, 0]),
            esrc=i64(plan.edge_src_local[rank, :k]), edst_ext=i64(plan.edge_dst_ext[rank, :k]),
            edst=i64(plan.edge_dst_global[rank, :k]), row_ptr=i64(plan.local_row_ptr[rank]),
            send_idx=i64(plan.send_idx[rank]),
        )


class HaloEmbedder(MultiChipEmbedder):
    """The vertex-sharded embedder: a ``MultiChipEmbedder`` whose state
    tensors hold this rank's R rows.  The same public surface as the JAX
    package's ``HaloEmbedder`` and the port's replicated one
    (``calculate_step``, ``calculate_embedding``, ``is_finished``,
    ``get_coordinates`` (gathered, n rows), ``get_weights``,
    ``set_coordinates``, ``set_weights``, ``get_loss``, ``get_timings``,
    ``iteration``, ``host_state``, ``plan``, ``path``, ``growth_events``,
    ``final_overflow``, checkpoints).  ``state`` is this rank's; assigning a
    whole (n-row) state, as a checkpoint restore does, keeps this rank's
    rows of it.  The span path is the windowed layout, as in the JAX
    halo step (``wembed_tpu/distributed/halo.py:200-220``): ``_span_layout``
    is ``MultiChipEmbedder``'s."""

    def __init__(
        self,
        graph: CSRGraph,
        opts: EmbedderOptions | None = None,
        mesh: Mesh | None = None,
        timer: Timer | None = None,
        initial_coordinates: np.ndarray | None = None,
        initial_weights: np.ndarray | None = None,
        verbose: bool = True,
        profile: bool = False,
        device: torch.device | str | None = None,
        share_stream: bool = True,
    ):
        mesh = mesh or make_mesh(device=device)
        self.plan = HaloPlan.build(graph, mesh.size)
        self._rank_plan = _RankPlan.build(self.plan, mesh.rank, mesh.device)
        self._sweep_cut = (0, 0)  # this rank's slice of the sweep's work items
        super().__init__(
            graph, opts, mesh, timer, initial_coordinates, initial_weights, verbose, profile,
            device, share_stream,
        )

    # ------------------------------------------------- rows and the index
    def _own_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's R rows of a whole (n, ...) tensor, zero past n."""
        rp = self._rank_plan
        out = torch.zeros((self.plan.R, *t.shape[1:]), dtype=t.dtype, device=self.device)
        out[: rp.rows] = t[rp.r0 : rp.r0 + rp.rows].to(self.device)
        return out

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole (n, ...) tensor of every rank's (R, ...) rows."""
        return self.mesh.all_gather(t)[: self.plan.n]

    def _span_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """This rank's chunk of the correction edges: the directed edges
        ``Share.cut(E)``, ceil(E / P) of them."""
        lo, hi = self._share_cut(self.graph.num_directed_edges)
        return self.graph.edge_src[lo:hi], self.graph.col_idx[lo:hi]

    def _share_cut(self, total: int) -> tuple[int, int]:
        return step_mod.Share(self.mesh.rank, self.mesh.size, None).cut(total)

    def _swap_index(self, index: SpanIndex) -> None:
        super()._swap_index(index)
        if self.opts.halo_resident_structures:
            self._sweep_cut = block_items(index, *self._share_cut(index.nb))
        else:
            self._sweep_cut = self._share_cut(self._items.shape[0])

    # ------------------------------------------------------------ the step
    def _attraction(self, pos_l: torch.Tensor, ext: torch.Tensor, generator: torch.Generator):
        """Attraction over this rank's directed edges, from its rows and the
        received halo (``ext``): (force (R, d), loss, coincident edges a
        row (R,) i32).  The edge kicks are the single-device raw draw,
        sliced at the rank's first edge and normalised where they kick
        (``edge_geometry.edge_attraction``)."""
        rp = self._rank_plan
        R, d = pos_l.shape
        dtype = pos_l.dtype
        e_all = self.graph.num_directed_edges
        if e_all == 0:
            zero = torch.zeros((), dtype=dtype, device=self.device)
            return torch.zeros_like(pos_l), zero, torch.zeros((R,), dtype=torch.int32, device=self.device)
        kicks = forces.normal_rows(generator, e_all, d, dtype)
        k = rp.esrc.shape[0]
        diff, dist2 = edges.edge_geometry_between(pos_l, ext, rp.esrc, rp.edst_ext)
        iw = self._inv_w.to(dtype)
        force_e, loss = edges.edge_attraction(
            diff, dist2, iw[rp.esrc + rp.r0], iw[rp.edst], self.opts,
            kicks[rp.edge_lo : rp.edge_lo + k],
        )
        coincident = edges.segment_sum((dist2 <= 0).to(dtype), rp.row_ptr).to(torch.int32)
        return edges.segment_sum(force_e, rp.row_ptr), loss, coincident

    def _repulsion(self, state: EmbedState, pos_full: torch.Tensor, in_index):
        """This rank's share of the repulsion pass: (force, zero_count,
        rep_loss, rep_count, overflow or None); force and zero_count are
        the rank's own (R, ...) rows on the dense and sampled paths, and
        (n_pad, ...) partials to reduce-scatter on the span path."""
        opts, n = self.opts, self.plan.n
        share = self._share
        if self._path == "dense":
            r0, r1 = share.cut(n)
            force, zero, _, loss, count = fused_dense_forces(
                pos_full, self._inv_w, self._dg.colors, self._adj, dim=pos_full.shape[1],
                L=opts.edge_length, att_scale=0.0, rep_scale=opts.repulsion_scale,
                additive=opts.additive_weights, rows=(r0, r1),
            )
            R = self.plan.R
            return forces.widen_rows(force, R, 0), forces.widen_rows(zero, R, 0), loss, count, None
        if self._path == "sampled":
            whole = dataclasses.replace(state, positions=pos_full)
            force, loss, count, zero = step_mod._sampled_repulsion(whole, self._inv_w, self._dg, opts, share)
            return self._own_rows(force), self._own_rows(zero), loss, count, None
        structures = build_span_structures(
            pos_full, self._inv_w, self._weights, self._dg.colors, self._index, opts,
            self._blk_t, in_index,
        )
        lo, hi = self._sweep_cut
        force, loss, count, overflow, zero = span_repulsion_forces(
            pos_full, self._inv_w, self._weights, self._dg.colors, self._index, opts,
            structures=structures, items=self._items[lo:hi], in_index=in_index,
        )
        return force, zero, loss, count, overflow

    def _scatter(self, force: torch.Tensor, zero: torch.Tensor):
        """Every rank's (n, ...) span partials summed into this rank's rows:
        one reduce-scatter of forces and counts packed in f64 (counts stay
        exact, f32 forces pass through f64 unchanged)."""
        n, d = force.shape
        packed = torch.zeros((self.plan.n_pad, d + 1), dtype=torch.float64, device=self.device)
        packed[:n, :d] = force
        packed[:n, d] = zero
        mine = self.mesh.reduce_scatter(packed)
        return mine[:, :d].to(force.dtype), mine[:, d].to(torch.int32)

    def _step(self, state: EmbedState) -> EmbedState:
        return self._finish_step(state, *self._force_pass(state))

    def _force_pass(self, state: EmbedState):
        """The halo exchange, attraction, this rank's share of repulsion and
        the reduce-scatter: (force (R, d), zero_count (R,) i32, att_loss,
        rep_loss, rep_count, overflow), the losses and the count this
        rank's partials, the overflow the same on every rank (the
        structures are built whole)."""
        mesh, rp = self.mesh, self._rank_plan
        pos_l = state.positions
        d = pos_l.shape[1]
        in_index = self._index.draw_members(state.generator) if self._span else None

        # halo exchange, then attraction into this rank's rows
        recv = mesh.all_to_all(pos_l[rp.send_idx])  # (P, H, d)
        ext = torch.cat([pos_l, recv.reshape(-1, d)])
        force, att_loss, coincident = self._attraction(pos_l, ext, state.generator)

        # repulsion over the gathered positions, back to the vertex ranges
        pos_full = self._all_rows(pos_l)
        rep, zero, rep_loss, rep_count, overflow = self._repulsion(state, pos_full, in_index)
        if self._span:
            rep, zero = self._scatter(rep, zero)
        else:
            overflow = state.overflow
            if self._path == "dense":
                zero = zero - coincident  # the attraction pass kicks the coincident edges
        return force + rep, zero, att_loss, rep_loss, rep_count, overflow

    def _finish_step(self, state, force, zero, att_loss, rep_loss, rep_count, overflow) -> EmbedState:
        """The kicks, the centre force and the optimizer on this rank's
        rows, then one all-reduce, packed in f64, of the losses, the count
        and the sums that gravity and the displacement metric need: with
        a = old - new before the centring, a row moves by a + mean, and
        sum |a + mean|^2 = sum |a|^2 + 2 mean . sum a + rows |mean|^2."""
        n, rows = self.plan.n, self._rank_plan.rows
        pos_l = state.positions
        d, dtype = pos_l.shape[1], pos_l.dtype
        positions, m, v, t = step_mod._apply_forces(
            state, self.opts, force, zero, self._schedule.at(state.iteration + 1), n, self._own_rows
        )
        f64 = torch.float64
        a = (pos_l[:rows] - positions[:rows]).to(f64)
        packed = torch.cat([
            torch.sum(positions[:rows], dim=0).to(f64), torch.sum(a, dim=0),
            torch.stack([torch.sum(a * a), att_loss.to(f64), rep_loss.to(f64), rep_count.to(f64)]),
        ])
        self.mesh.all_reduce(packed)
        mean = packed[:d] / n
        positions = positions.clone()
        positions[:rows] = positions[:rows] - mean.to(dtype)
        moved = packed[2 * d] + 2.0 * torch.dot(mean, packed[d : 2 * d]) + n * torch.dot(mean, mean)
        return step_mod._next_state(
            state, positions, m, v, t, (moved / n).to(torch.float32), packed[2 * d + 1].to(att_loss.dtype),
            packed[2 * d + 2].to(rep_loss.dtype), packed[2 * d + 3].to(torch.int64), overflow,
        )
