"""The span edge pass at d > 8, where the card runs the general variant
(``csrc/edge_pass.cu:segment_pass_general_kernel``), on the CPU.

The plain version against the JAX package at d = 9 and 16: the sweep plus
the fused or the correction pass against ``span_fused_forces`` /
``span_repulsion_forces`` and the ``cell_*`` functions (the Pallas sweep in
interpret mode) in f32, against the jnp dense oracle in f64, and
attraction against ``attraction_forces``, each at the tolerances of
tests/test_torch_edge_pass.py.  Then a numpy transcription of the general
kernel's work split (the schedule's heavy segments in chunks of 32 edges a
computing warp, folded by one warp or, for wide rows, by the CTA in slabs
of 256 columns with the sums carried in the output row; medium segments in
rounds of 32; light groups with each edge's source found by the kernel's
binary search; dist2 staged 16 columns at a time) held bitwise to a plain
fold of the same inputs, and the constants and argument layout of
``kernels/edge_pass.py`` against the CUDA source.  Both folds take numpy's
sqrt: torch's vectorised CPU sqrt is not correctly rounded, the card's is."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import test_torch_edge_pass as tep

from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.core.edge_schedule import HEAVY, LIGHT, WARPS, EdgeSchedules
from wembed_tpu_torch.kernels import edge_pass as ep
from wembed_tpu_torch.kernels.span_sweep import ST

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parent.parent / "wembed_tpu_torch" / "csrc" / "edge_pass.cu"
THREADS = 256  # a CTA of the kernel: a heavy segment's fold slab above SPLIT_DIM


# ------------------------------------------------ against the JAX package


@pytest.mark.parametrize("kw", [
    dict(d=9, coincident=True, spread=0.3), dict(d=16, spread=0.2),
    dict(d=9, layout="cells", spread=0.3), dict(d=16, layout="cells", coincident=True, spread=0.2),
])
def test_span_modes_match_jax_f32_at_wide_d(kw):
    """``test_span_modes_match_jax_f32`` at the general variant's widths:
    counts and zero counts equal, forces and losses within its tolerances.
    The cloud is narrower than at d <= 4, so that neighbours fall inside
    the span radius."""
    tep.test_span_modes_match_jax_f32(kw)


def test_span_modes_match_the_dense_oracle_f64_at_d16():
    """``test_span_modes_match_the_dense_oracle_f64`` at d = 16: with no
    window truncated, sweep plus correction is the exact all-pairs
    repulsion and sweep plus fused pass that plus attraction, within rtol
    1e-9, zero counts equal."""
    tep.test_span_modes_match_the_dense_oracle_f64(dict(d=16, coincident=True, spread=0.2))


@pytest.mark.parametrize("dtype,additive,coincident", [("float64", False, True), ("float32", True, False)])
def test_attraction_matches_jax_at_d16(dtype, additive, coincident):
    """``test_attraction_matches_jax`` at d = 16 (f64 within rtol 1e-9, f32
    within test_forces_match_jax's tolerance)."""
    tep.test_attraction_matches_jax(16, dtype, additive, coincident)


# ------------------------------------- the general kernel's work, in numpy


class Inputs:
    """One pass's inputs as numpy arrays in dtype T: a graph whose vertex 0
    has ``hub`` edges (a heavy segment), a few medium segments, light
    vertices of 0-12 edges, a share of the edges (their offsets clipped to
    it) and every 29th edge's dst moved onto its source (coincident),
    some of those with extreme kick draws."""

    def __init__(self, d, dtype, hub=600, n=500, seed=0):
        rng = np.random.default_rng(seed + d)
        T = self.T = dtype
        deg = rng.integers(0, 13, size=n)
        deg[0] = hub
        deg[1:8] = [40, 256, 33, 257, 100, 200, 70]
        src = np.repeat(np.arange(n), deg)
        dst = (src + rng.integers(1, n, size=src.shape[0])) % n
        pos = rng.uniform(0.0, np.sqrt(6.0 / d), size=(n, d))
        picks = np.arange(0, src.shape[0], 29)
        for e in picks:
            pos[dst[e]] = pos[src[e]]
        self.n, self.d = n, d
        self.row_ptr = np.r_[0, np.cumsum(deg)].astype(np.int64)
        self.src, self.dst = src, dst
        self.pos = pos.astype(T)
        self.iw = rng.uniform(0.5, 1.5, n).astype(T)
        self.lw = rng.uniform(0.5, 2.0, n).astype(T)
        self.colors = rng.integers(0, 40, n).astype(np.int32)
        self.bm2 = rng.uniform(0.5, 2.0, src.shape[0]).astype(np.float32)
        self.member_cov = rng.random(src.shape[0]) < 0.85  # in the index and covered by the source's block
        self.base = rng.normal(size=(n, d)).astype(T)
        self.base_zero = rng.integers(0, 50, n).astype(np.int32)
        kicks = rng.normal(size=(src.shape[0], d))
        coincident = np.flatnonzero(np.all(self.pos[dst] == self.pos[src], axis=1))
        big, tiny, sub = (1e30, 1e-30, 1e-20) if T == np.float32 else (1e200, 1e-200, 1e-160)
        ramp = np.arange(1, d + 1)
        for e, row in zip(coincident[1::7], (0.0 * ramp, tiny * ramp, sub * ramp, big * ramp, -big * ramp)):
            kicks[e] = row
        self.kicks = kicks.astype(T)
        self.coincident = coincident
        self.L, self.att, self.rep, self.additive = 1.0, 1.0, 1.0, False

    def share(self, rank, size):
        """The inputs of one rank's share: its edges, the offsets clipped to
        them (``core/forces.py:edge_share``)."""
        per = -(-self.src.shape[0] // size)
        lo, hi = min(rank * per, self.src.shape[0]), min((rank + 1) * per, self.src.shape[0])
        out = object.__new__(Inputs)
        out.__dict__.update(self.__dict__)
        out.row_ptr = np.clip(self.row_ptr, lo, hi) - lo
        for name in ("src", "dst", "bm2", "member_cov", "kicks"):
            setattr(out, name, getattr(self, name)[lo:hi])
        return out


def kick_norm(g):
    """``kick_scale``: norm2 = 0 + g_0^2 + ... in ascending k, sqrt, the norm
    where it is positive, else 1 (rows of g)."""
    norm2 = np.zeros(g.shape[0], g.dtype)
    for k in range(g.shape[1]):
        norm2 = norm2 + g[:, k] * g[:, k]
    norm = np.sqrt(norm2)
    return np.where(norm > 0, norm, g.dtype.type(1))


def coefficients(mode, x, j, src, dist2):
    """(coefficient, attraction loss terms, correction loss terms, counted,
    counted coincident) of edges j with sources src, from their dist2: the
    kernel's ``general_coeff``, each operation rounded alone in T."""
    T = x.T
    t = x.dst[j]
    iw_s, iw_t = x.iw[src], x.iw[t]
    ws = iw_s + iw_t if x.additive else iw_s * iw_t
    L, one, zero = T(x.L), T(1), T(0)
    dist = np.sqrt(dist2)
    posd = dist2 > 0
    if mode == "attraction":
        act = dist * ws > L
        coeff = np.where(act, (T(x.att) * ws) / np.maximum(dist, T(1e-30)), zero)
        none = np.zeros(j.shape[0], bool)
        return coeff, (dist - (one / ws) * L)[act], np.zeros(0, T), none, none
    lw = x.lw[src]
    included = (dist2 <= (lw * lw) * x.bm2[j].astype(T)) & (x.colors[src] != x.colors[t]) & x.member_cov[j]
    active_r = included & (dist2 * (ws * ws) <= T(x.L * x.L)) & posd
    att = np.zeros(0, T)
    if mode == "fused":
        inv = one / np.maximum(dist, T(1e-30))
        act_a = dist * ws > L
        coeff = np.where(act_a, (T(x.att) * ws) * inv, zero) + np.where(active_r, (T(x.rep) * ws) * inv, zero)
        att = (dist - (one / ws) * L)[act_a]
    else:
        coeff = np.where(active_r, (T(x.rep) * ws) * (one / dist), zero)
    l_over_ws = (one / ws) * L if x.additive else (L * (one / iw_s)) * (one / iw_t)
    return coeff, att, (l_over_ws - dist)[active_r], included, included & ~posd


def plain_fold(mode, x):
    """The plain version in numpy: every edge's row (its pull, or at a
    coincident edge its kick over the kick's norm), each vertex's rows
    folded in edge order from 0, plus the given force (span modes); the
    zero counts less the counted coincident neighbours."""
    n = x.n
    src = np.repeat(np.arange(n), np.diff(x.row_ptr))
    diff = x.pos[x.dst] - x.pos[src]
    dist2 = np.zeros(src.shape[0], x.T)
    for k in range(x.d):
        dist2 = dist2 + diff[:, k] * diff[:, k]
    coeff, att, closs, included, zf = coefficients(mode, x, np.arange(src.shape[0]), src, dist2)
    rows = coeff[:, None] * diff
    kick = ~(dist2 > 0) if mode != "correction" else np.zeros(src.shape[0], bool)
    rows[kick] = x.kicks[kick] / kick_norm(x.kicks[kick])[:, None]
    deg = np.diff(x.row_ptr)
    acc = np.zeros((n, x.d), x.T)
    for r in range(int(deg.max(initial=0))):
        v = np.flatnonzero(deg > r)
        acc[v] = acc[v] + rows[x.row_ptr[v] + r]
    if mode == "attraction":
        return acc, None, att, closs, 0
    zc = np.bincount(src[zf], minlength=n).astype(np.int32)
    return x.base + acc, x.base_zero - zc, att, closs, int(included.sum())


def transcription(mode, x):
    """The general kernel's work over the edges' schedule, as the card runs
    it (``segment_pass_general_kernel``; the lanes of a warp are numpy's
    columns): (force, zero counts, attraction loss terms, correction loss
    terms, counted neighbours), every vertex's row and count written."""
    T, n, d = x.T, x.n, x.d
    span = mode != "attraction"
    sched = EdgeSchedules(x.row_ptr, torch.as_tensor(x.dst)).get()
    table = sched.table.numpy()
    out = np.full((n, d), np.nan, T)
    zero = np.full(n, -(2**31), np.int32)
    tally = dict(att=[], closs=[], inc=0)

    def write(v, cols, acc):
        out[v, cols] = x.base[v, cols] + acc if span else acc

    lane_cols = ep.SLAB if np.dtype(T).itemsize == 4 else 4  # LaneSlab: the columns a lane holds

    def run_round(j, srcs):
        """general_round, an edge a lane: dist2 over the lane's row
        lane_cols columns at a time in ascending k, the coefficient and kick
        norm; the rows themselves into the stage where they fit a lane."""
        assert 0 <= j.shape[0] <= 32
        diff = x.pos[x.dst[j]] - x.pos[srcs]
        dist2 = np.zeros(j.shape[0], T)
        for c0 in range(0, d, lane_cols):
            for k in range(c0, min(d, c0 + lane_cols)):
                dist2 = dist2 + diff[:, k] * diff[:, k]
        coeff, att, closs, included, zf = coefficients(mode, x, j, srcs, dist2)
        tally["att"].append(att)
        tally["closs"].append(closs)
        tally["inc"] += int(included.sum())
        den = np.zeros(j.shape[0], T)
        kick = ~(dist2 > 0) if mode != "correction" else np.zeros(j.shape[0], bool)
        den[kick] = kick_norm(x.kicks[j[kick]])
        if d > lane_cols:
            return coeff, den, x.dst[j], zf, None
        rows = coeff[:, None] * diff
        rows[kick] = x.kicks[j[kick]] / den[kick][:, None]
        return coeff, den, x.dst[j], zf, rows

    def lane_rows(j, v):
        """heavy_row: an edge a lane, its row read lane_cols columns at a
        time, dist2 in ascending k, the coefficient, then its row."""
        diff = x.pos[x.dst[j]] - x.pos[v]
        dist2 = np.zeros(j.shape[0], T)
        for c0 in range(0, d, lane_cols):
            for k in range(c0, min(d, c0 + lane_cols)):
                dist2 = dist2 + diff[:, k] * diff[:, k]
        coeff, att, closs, included, zf = coefficients(mode, x, j, np.full(j.shape[0], v), dist2)
        tally["att"].append(att)
        tally["closs"].append(closs)
        tally["inc"] += int(included.sum())
        rows = coeff[:, None] * diff
        kick = ~(dist2 > 0) if mode != "correction" else np.zeros(j.shape[0], bool)
        rows[kick] = x.kicks[j[kick]] / kick_norm(x.kicks[j[kick]])[:, None]
        return rows, zf

    def fold(acc, e0, e1, j0, coef, den, dsts, stage, cols, sp):
        """fold_stage (the staged rows) or fold_rows (each row formed again
        from the positions): acc plus the slots' rows in slot order, column
        by column."""
        for e in range(e0, e1):
            if stage is not None:
                row = stage[e, cols]
            else:
                row = coef[e] * (x.pos[dsts[e], cols] - sp)
                if den[e] != 0:
                    row = x.kicks[j0 + e, cols] / den[e]
            acc = acc + row
        return acc

    for b in range(sched.heavy):  # a CTA each
        v, _, lo, m = (int(u) for u in table[b])
        hi = lo + m
        split = d <= ep.SPLIT_DIM
        per = (WARPS - split) * 32
        chunks = -(-m // per)
        acc, cols, zc = np.zeros(d, T), np.arange(d), 0
        for i in range(chunks):
            j0 = lo + i * per
            cnt = min(per, hi - j0)
            coef, den, dsts = np.zeros(per, T), np.zeros(per, T), np.zeros(per, np.int64)
            rows = np.zeros((d, per), T)  # a split chunk's buffer, column-major
            for w in range(0, cnt, 32):  # the computing warps
                j = np.arange(j0 + w, min(j0 + w + 32, hi))
                k = slice(w, w + j.shape[0])
                if split:  # heavy_row: an edge a lane, its row into the chunk's buffer
                    lane, zf = lane_rows(j, v)
                    rows[:, k] = lane.T
                else:
                    coef[k], den[k], dsts[k], zf, _ = run_round(j, np.full(j.shape[0], v))
                zc += int(zf.sum())
            if split:  # warp 0, lane c column c: fold_column over the buffer, the sum in a register
                for e in range(cnt):
                    acc = acc + rows[:, e]
                continue
            for c0 in range(0, d, THREADS):  # the CTA, a thread a column, the sums carried in the output row
                c = np.arange(c0, min(d, c0 + THREADS))
                got = fold(np.zeros(c.shape[0], T) if i == 0 else out[v, c], 0, cnt, j0, coef, den, dsts, None, c,
                           x.pos[v, c])
                if i + 1 == chunks:
                    write(v, c, got)
                else:
                    out[v, c] = got
        if split:
            write(v, cols, acc)
        zero[v] = x.base_zero[v] - zc
    for i in range(sched.medium):  # a warp each: rounds of 32, the sums carried in registers or the output row
        v, _, lo, m = (int(u) for u in table[sched.heavy + i])
        hi, zc, cols, acc = lo + m, 0, np.arange(d), np.zeros(d, T)
        for j0 in range(lo, hi, 32):
            j = np.arange(j0, min(j0 + 32, hi))
            coef, den, dsts, zf, stage = run_round(j, np.full(j.shape[0], v))
            zc += int(zf.sum())
            if d <= 32:  # lane c's column in a register
                acc = fold(acc, 0, j.shape[0], j0, coef, den, dsts, stage, cols, x.pos[v])
                continue
            got = fold(np.zeros(d, T) if j0 == lo else out[v], 0, j.shape[0], j0, coef, den, dsts, None, cols,
                       x.pos[v])
            if j0 + 32 >= hi:
                write(v, cols, got)
            else:
                out[v] = got
        if d <= 32:
            write(v, cols, acc)
        zero[v] = x.base_zero[v] - zc
    for g in range(sched.groups):  # a warp each, one round
        v0, nv, base, ne = (int(u) for u in table[sched.heavy + sched.medium + g])
        assert nv <= LIGHT and ne <= LIGHT
        first = [int(x.row_ptr[v0 + k] - base) for k in range(nv)]
        length = [int(x.row_ptr[v0 + k + 1] - x.row_ptr[v0 + k]) for k in range(nv)]
        owner = []
        for lane in range(ne):  # the source of edge `lane`: the kernel's binary search over the lanes' offsets
            k = 0
            for step in (16, 8, 4, 2, 1):
                if k + step < nv and first[k + step] <= lane:
                    k += step
            owner.append(v0 + k)
        j = base + np.arange(ne)
        coef, den, dsts, zf, stage = run_round(j, np.asarray(owner, np.int64))
        for k in range(nv):
            f, ln = first[k], length[k]
            write(v0 + k, np.arange(d), fold(np.zeros(d, T), f, f + ln, base, coef, den, dsts, stage, np.arange(d),
                                              x.pos[v0 + k]))
            zero[v0 + k] = x.base_zero[v0 + k] - int(zf[f:f + ln].sum())
    cat = (lambda parts: np.concatenate(parts) if parts else np.zeros(0, T))
    return out, zero if span else None, cat(tally["att"]), cat(tally["closs"]), tally["inc"]


@pytest.mark.parametrize("mode", ep.MODES)
@pytest.mark.parametrize("d,dtype", [(9, np.float32), (16, np.float32), (16, np.float64), (33, np.float32),
                                     (300, np.float32)])
def test_kernel_work_split_is_bitwise_the_plain_fold(d, dtype, mode):
    """The transcription of the kernel's work (heavy segments of 600, 257
    and 256 edges in chunks of 224 or 256, a fold by one warp at d <= 32 and
    by the CTA in slabs above; medium segments of 33-200 edges; light
    groups; at d <= 16 the folds read the stage) gives the plain fold's
    forces and zero counts bit for bit, over all the edges and over one
    rank's share of three (its offsets clipped: most segments empty, one
    cut); the counts of neighbours equal, the losses, added in another
    order, within 1e-5 (f32) or 1e-12 (f64)."""
    whole = Inputs(d, dtype)
    sched = EdgeSchedules(whole.row_ptr, torch.as_tensor(whole.dst)).get()
    assert sched.heavy == 2 and sched.medium == 6 and sched.groups > 0
    assert whole.coincident.shape[0] > 10
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    for x in (whole, whole.share(1, 3)):
        with np.errstate(over="ignore", under="ignore", invalid="ignore"):
            got = transcription(mode, x)
            want = plain_fold(mode, x)
        assert not np.isnan(got[0]).any()  # every row written
        assert got[0].tobytes() == want[0].tobytes()
        if mode != "attraction":
            np.testing.assert_array_equal(got[1], want[1])
            assert got[4] == want[4] > 0
            assert int((x.base_zero - want[1]).sum()) > 0  # counted coincident neighbours
        for k in (2, 3):
            np.testing.assert_allclose(got[k].sum(dtype=np.float64), want[k].sum(dtype=np.float64), rtol=rtol)


@pytest.mark.parametrize("mode", ep.MODES)
def test_plain_fold_transcribes_the_plain_version(mode):
    """The numpy plain fold is ``edge_pass_reference``'s arithmetic: on the
    same f64 inputs (the structures' windows replaced by the given
    coverage) the counts and zero counts are equal and the forces and
    losses agree to rounding (torch's CPU sqrt is not numpy's)."""
    x = Inputs(16, np.float64, hub=300, n=300)
    force, zero, att, closs, inc = plain_fold(mode, x)
    src = torch.as_tensor(np.repeat(np.arange(x.n), np.diff(x.row_ptr)))
    kw = dict(kicks=torch.tensor(x.kicks))
    if mode != "attraction":
        covered = torch.tensor(x.member_cov)
        structures = SimpleNamespace(lwpow=torch.tensor(x.lw), covers=lambda s, t: covered)
        kw = dict(kicks=kw["kicks"] if mode == "fused" else None, structures=structures,
                  colors=torch.tensor(x.colors), bm2=torch.tensor(x.bm2), force=torch.tensor(x.base),
                  zero_count=torch.tensor(x.base_zero))
    opts = EmbedderOptions(embedding_dimension=x.d)
    assert (opts.edge_length, opts.attraction_scale, opts.repulsion_scale, opts.additive_weights) == (
        x.L, x.att, x.rep, x.additive)
    want = ep.edge_pass_reference(mode, torch.tensor(x.pos), torch.tensor(x.iw), src, torch.tensor(x.dst),
                                  torch.tensor(x.row_ptr), opts, **kw)
    scale = float(np.abs(force).max())
    np.testing.assert_allclose(force, want.force.numpy(), rtol=1e-12, atol=1e-12 * scale)
    if mode != "correction":
        np.testing.assert_allclose(att.sum(), float(want.att_loss), rtol=1e-12)
    if mode != "attraction":
        np.testing.assert_array_equal(zero, want.zero_count.numpy())
        assert inc == int(want.corr_count) > 0
        np.testing.assert_allclose(closs.sum(), float(want.corr_loss), rtol=1e-12)
        assert int((x.base_zero - zero).sum()) > 0


# --------------------------------------------------- the CUDA source's terms


def _constexprs(text: str) -> dict:
    """The source's integer constants whose values follow from the ones
    before them (``constexpr int kName = expr;``)."""
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        try:
            out[name] = int(eval(expr, {"__builtins__": {}}, dict(out)))
        except (NameError, SyntaxError):
            pass  # a constant of a type's size
    return out


def test_constants_match_the_cuda_source():
    """The constants the wrapper and the schedule size their work by are the
    CUDA source's, and each has the C function the library's loader checks
    (``edge_pass._CONSTANTS``)."""
    text = SOURCE.read_text()
    k = _constexprs(text)
    assert k["kThreads"] == THREADS == WARPS * 32 == ep._BLOCK
    assert k["kWarps"] == WARPS
    assert k["kLight"] == LIGHT
    assert k["kST"] == ST
    assert k["kMaxFastDim"] == ep.MAX_FAST_DIM
    assert k["kSlab"] == ep.SLAB
    assert k["kStageStride"] == ep.SLAB + 1
    assert k["kSplitDim"] == ep.SPLIT_DIM
    assert ep.SLAB < ep.SPLIT_DIM <= 32 < HEAVY  # warp 0 alone folds a split heavy row
    names = {"kThreads": THREADS, "kST": ST, "kLight": LIGHT, "kWarps": WARPS, "kMaxFastDim": ep.MAX_FAST_DIM,
             "kSlab": ep.SLAB, "kSplitDim": ep.SPLIT_DIM}
    for fn, want in ep._CONSTANTS.items():
        body = re.search(rf"int {fn}\(\) {{ return wembed_edge::(\w+); }}", text)
        assert body is not None, fn
        assert names[body.group(1)] == want


def test_argument_struct_matches_the_cuda_source():
    """``_Args`` is ``struct Args`` field for field, in order and kind
    (pointers, int64, double: 8 bytes each), with no scratch rows: the
    general variant reads the schedule as the d <= 8 kernel does."""
    text = SOURCE.read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        m = re.match(r"(const\s+)?([\w:]+)(\*?)\s+(.+);$", decl)
        kind = "ptr" if m.group(3) else {"int64_t": "i64", "double": "f64"}[m.group(2)]
        fields += [(name.strip().lstrip("*"), kind) for name in m.group(4).split(",")]
    kinds = {torch_kind: k for torch_kind, k in (("c_void_p", "ptr"), ("c_long", "i64"), ("c_double", "f64"))}
    got = [(name, kinds.get(ctype.__name__, ctype.__name__)) for name, ctype in ep._Args._fields_]
    assert got == fields
    assert not {"net", "zflag", "src", "dst"} & {name for name, _ in fields}
    assert "sched" in dict(fields) and "dst32" in dict(fields)
    general = text[text.index("// --------------------------------------------------- general variant"):
                   text.index("// ---------------------------------------------------------------- launches")]
    assert general.count("__global__") == 1 and "segment_pass_general_kernel(const Args a)" in general
    assert "atomicAdd(&g_ctas_done" in general and "a.net" not in general and "a.zflag" not in general
