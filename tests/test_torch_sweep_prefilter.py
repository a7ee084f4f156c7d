"""The span sweep's tensor-core prefilter (``csrc/span_sweep.cu``, emulated
by ``kernels/span_sweep.py:span_prefilter_reference``): it must never
reject a pair that the exact radius test accepts, and its margin must stay
narrow enough to reject most of the rest.

The exact test is the kernel's and the plain version's f32 arithmetic:
per-dimension differences, squares and adds in ascending order, each
rounded, against the f32 product lw^2 * bm2.  The cases hold pairs placed
at the radius edge and a few ulps to either side of it, coordinates up to
1e4, the +-1e15 sentinel records of padding slots and partial indexes,
coincident points and additive weights, at d = 2, 4 and 8; the GIRG-like
case's candidates are also counted by the JAX package's Pallas sweep in
interpret mode."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from wembed_tpu.core import EmbedderOptions as JaxOptions
from wembed_tpu.core import weights as jax_weights
from wembed_tpu.core.state import DeviceGraph as JaxDeviceGraph
from wembed_tpu.graphs import generators as jax_generators
from wembed_tpu.kernels import span_sparse as jax_span

from wembed_tpu_torch.core import EmbedderOptions
from wembed_tpu_torch.kernels import span_sparse, span_sweep

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import radius_edge  # noqa: E402

torch.set_num_threads(1)

SENTINEL = 1e15  # the records' padding positions (kernels/span_sparse.py)


def exact_dist2(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(Q, M) f32 squared distances in the exact test's order of operations."""
    diff = q[:, None, :] - s[None, :, :]
    out = np.zeros(diff.shape[:2], np.float32)
    for k in range(q.shape[1]):
        out = out + diff[..., k] * diff[..., k]
    return out


def records(pos, invw, radius, rawexp) -> torch.Tensor:
    return torch.tensor(np.concatenate(
        [pos, invw[:, None], radius[:, None], rawexp[:, None]], axis=1).astype(np.float32))


def adversarial_block(d, seed, offset, spread, k, n_sentinel_q, n_sentinel_s, additive):
    """One block of 64 query records and 96 member records: members at the
    radius edge of a query (k ulp steps beyond it), coincident with one,
    far, or sentinels, as the exact test's f32 arithmetic sees them."""
    rng = np.random.default_rng(seed)
    nq, ns = 64, 96
    centre = rng.uniform(-offset, offset, d)
    qpos = (centre + rng.normal(size=(nq, d)) * spread).astype(np.float32)
    lw2 = (rng.pareto(1.5, nq) + 1.0).astype(np.float32) ** 2
    bm2 = (rng.pareto(1.5, ns) + 1.0).astype(np.float32) ** 2
    partner = rng.integers(0, nq, ns)
    thr = lw2[partner] * bm2
    direction = rng.normal(size=(ns, d))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    spos = (qpos[partner] + direction * np.sqrt(thr.astype(np.float64))[:, None]).astype(np.float32)
    spos = radius_edge(qpos[partner], spos, thr, k)
    coincident = rng.random(ns) < 0.1
    spos[coincident] = qpos[partner[coincident]]
    far = rng.random(ns) < 0.1
    spos[far] = (centre + rng.normal(size=(far.sum(), d)) * 50 * spread).astype(np.float32)
    # padding slots: queries at +1e15 with radius factor 0; members at -1e15
    # (and some at +1e15, where they meet a padding query) with bm2 0
    lw2[nq - n_sentinel_q:] = 0.0
    qpos[nq - n_sentinel_q:] = SENTINEL
    sent = slice(ns - n_sentinel_s, ns)
    bm2[sent] = 0.0
    spos[sent] = -SENTINEL
    spos[ns - n_sentinel_s: ns - n_sentinel_s // 2] = SENTINEL
    w_q, w_s = rng.pareto(2.0, nq) + 1.0, rng.pareto(2.0, ns) + 1.0
    invw_q, invw_s = (w_q if additive else 1.0 / w_q), (w_s if additive else 1.0 / w_s)
    qrec = records(qpos, invw_q, lw2, 1.0 / invw_q)
    srec = records(spos, invw_s, bm2, 1.0 / invw_s)
    return qrec, srec


def exact_valid(qrec, srec, d):
    q, s = qrec.numpy(), srec.numpy()
    return exact_dist2(q[:, :d], s[:, :d]) <= q[:, d + 1, None] * s[None, :, d + 1]


@pytest.mark.parametrize("d", [2, 4, 8])
@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    offset=st.sampled_from([0.0, 1.0, 300.0, 1e4]),
    spread=st.floats(0.05, 20.0),
    k=st.integers(-3, 3),
    n_sentinel_q=st.integers(0, 40),
    n_sentinel_s=st.integers(0, 60),
    additive=st.booleans(),
)
def test_prefilter_never_rejects_an_exact_candidate(d, seed, offset, spread, k, n_sentinel_q,
                                                    n_sentinel_s, additive):
    qrec, srec = adversarial_block(d, seed, offset, spread, k, n_sentinel_q, n_sentinel_s, additive)
    valid = exact_valid(qrec, srec, d)
    passed = span_sweep.span_prefilter_reference(qrec, srec, dim=d).numpy()
    assert not (valid & ~passed).any()


@pytest.mark.parametrize("d", [2, 4, 8])
def test_radius_edge_pairs_pass_and_their_neighbours_are_tested(d):
    """At k = 0 every placed pair is inside the radius by at most one f32
    step and must pass; one step out it is outside, and the margin keeps
    the prefilter's extra passes among such pairs."""
    qrec, srec = adversarial_block(d, 7, 1e4, 3.0, 0, 0, 0, False)
    valid = exact_valid(qrec, srec, d)
    passed = span_sweep.span_prefilter_reference(qrec, srec, dim=d).numpy()
    assert valid.sum() >= 80  # the placed pairs (and a few more)
    assert not (valid & ~passed).any()
    q_out, s_out = adversarial_block(d, 7, 1e4, 3.0, 1, 0, 0, False)
    assert exact_valid(q_out, s_out, d).sum() < valid.sum()


def test_sentinels_do_not_widen_the_margin():
    """Padding queries and members (+-1e15) take their margin from their own
    norms: the real pairs' passes are those of the block without them."""
    d = 2
    qrec, srec = adversarial_block(d, 3, 300.0, 2.0, 0, 0, 0, False)
    base = span_sweep.span_prefilter_reference(qrec, srec, dim=d).numpy()
    qpad, spad = qrec.clone(), srec.clone()
    qpad[-20:, :d], qpad[-20:, d + 1] = SENTINEL, 0.0
    spad[-30:, :d], spad[-30:, d + 1] = -SENTINEL, 0.0
    padded = span_sweep.span_prefilter_reference(qpad, spad, dim=d).numpy()
    np.testing.assert_array_equal(padded[:-20, :-30], base[:-20, :-30])
    assert not padded[-20:, :-30].any() and not padded[:-20, -30:].any()


def test_nan_and_huge_records_pass_to_the_exact_test():
    """A record whose squared norm is NaN or at least 2^110 passes every pair:
    the exact test then decides, as before."""
    d = 2
    qrec, srec = adversarial_block(d, 5, 10.0, 1.0, 0, 0, 0, False)
    qrec[0, 0] = float("nan")
    qrec[1, :d] = 2.0**60
    srec[0, 1] = float("nan")
    passed = span_sweep.span_prefilter_reference(qrec, srec, dim=d).numpy()
    assert passed[0].all() and passed[1].all() and passed[:, 0].all()


def test_tf32_rounding_and_split():
    rng = np.random.default_rng(0)
    x = torch.tensor(np.concatenate([
        rng.normal(size=1000) * 10.0 ** rng.integers(-30, 30, 1000),
        [0.0, -0.0, 1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11), 3.4e38],
    ]).astype(np.float32))
    big = span_sweep._tf32(x)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()  # 10 stored mantissa bits
    assert torch.equal(span_sweep._tf32(big), big)
    finite = torch.isfinite(big)
    rel = ((x - big).abs() / x.abs().clamp_min(1e-38))[finite & (x != 0)]
    assert float(rel.max()) <= 2.0**-11
    # ties go away from zero
    assert float(big[-4]) == 1.0 + 2**-10 and float(big[-2]) == -(1.0 + 2**-10)
    assert float(big[-3]) == 1.0 + 4 * 2**-11
    small = span_sweep._tf32(x - big)
    residual = (x.double() - big.double() - small.double()).abs()
    assert bool((residual[finite] <= 2.0**-22 * x.double().abs()[finite] + 1e-45).all())


def test_prefilter_constants_match_the_cuda_source():
    src = (Path(span_sweep.__file__).resolve().parent.parent / "csrc" / "span_sweep.cu").read_text()

    def constant(name):
        return float.fromhex(re.search(rf"constexpr float {name} = (0x[0-9a-fp+-]+)f;", src).group(1))

    assert constant("kMarginRel") == span_sweep.PREFILTER_MARGIN_REL
    assert constant("kMarginAbs") == span_sweep.PREFILTER_MARGIN_ABS
    assert constant("kNormCap") == span_sweep.PREFILTER_NORM_CAP


# --------------------------------------------------- a GIRG-like sweep


def girg_case(d, seed=3, n=1500):
    g, _, _ = jax_generators.girg(n, dim=2, avg_degree=12, ple=2.2, rng=np.random.default_rng(seed))
    jopts = JaxOptions(embedding_dimension=d)
    opts = EmbedderOptions(embedding_dimension=d)
    w = jax_weights.initial_weights(g, jopts)
    inv_w = jax_weights.inv_exp_weights(w, d)
    pos = (np.random.default_rng(1).normal(size=(g.num_vertices, d)) * 2.0
           * np.array([3.0, 1.5, 1.0, 1.0])[:d]).astype(np.float32)
    idx = span_sparse.SpanIndex.build(w, opts, g.edge_src, g.col_idx, span_scale=6.0)
    s = span_sparse.build_span_structures(
        torch.tensor(pos), torch.tensor(inv_w, dtype=torch.float32),
        torch.tensor(w, dtype=torch.float32), torch.tensor(g.colors), idx, opts,
    )
    jidx = jax_span.SpanIndex.build(w, jopts, g.edge_src, g.col_idx, span_scale=6.0)
    s_j = jax_span.build_span_structures(
        jnp.asarray(pos), jnp.asarray(inv_w, jnp.float32), jnp.asarray(w, jnp.float32),
        JaxDeviceGraph.build(g).colors, jidx, jopts,
    )
    out = np.asarray(jax_span.span_query(s_j, jidx, jopts, interpret=True))
    jax_count = int(out.reshape(-1, out.shape[-1])[: jidx.nb * jax_span._Q, d + 2].sum())
    return s, idx, jax_count


@pytest.mark.parametrize("d", [2, 4])
def test_pass_rate_on_a_girg_like_sweep(d):
    """Over every work tile of a GIRG-like sweep the emulated prefilter keeps
    every pair within the radius, and passes at most 1.1 times as many
    pairs (chip_smoke.py prints the card's own ratio on girg100k)."""
    s, idx, jax_count = girg_case(d)
    t = idx.tensors(torch.device("cpu"))
    qblk, stile = span_sweep._work_tiles(s.blk_t, s.start_tile, t.tile_off)
    q3, s3 = s.qrec.view(-1, span_sweep.Q, d + 3), s.srec.view(-1, span_sweep.ST, d + 3)
    qc3, sc3 = s.qcol.view(-1, span_sweep.Q), s.scol.view(-1, span_sweep.ST)
    passes = within = candidates = 0
    for b, tile in zip(qblk.tolist(), stile.tolist()):
        passed = span_sweep.span_prefilter_reference(q3[b], s3[tile], dim=d).numpy()
        valid = exact_valid(q3[b], s3[tile], d)
        assert not (valid & ~passed).any()
        passes += int(passed.sum())
        within += int(valid.sum())
        candidates += int((valid & (qc3[b][:, None] != sc3[tile][None, :]).numpy()).sum())
    pairs = qblk.shape[0] * span_sweep.Q * span_sweep.ST
    assert candidates == jax_count > 0
    assert within <= passes <= 1.1 * within
    assert passes < 0.5 * pairs
