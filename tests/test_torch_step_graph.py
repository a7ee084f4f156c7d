"""The captured step of the port (``core/step.py:StepGraph``) on the CPU,
where its stand-in replays by calling the step: the optimizer's device
scalars against the update by host scalars, the runner's trajectory
against the eager loop's, what drops the captured step, and the launch
counters' bookkeeping.  On the card, ``chip_smoke.py`` (its step-graph
phase) holds captured and eager runs to the same bits."""

import weakref

import numpy as np
import pytest
import torch

from wembed_tpu_torch.core import EmbedderOptions, RepulsionMode, WEmbedEmbedder, optim
from wembed_tpu_torch.core import step as step_mod
from wembed_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from wembed_tpu_torch.core.options import OptimizerType
from wembed_tpu_torch.graphs import generators
from wembed_tpu_torch.kernels import fused_dense, launch_counts, span_sparse, span_sweep
from wembed_tpu_torch.multilevel import LayeredEmbedder
from wembed_tpu_torch.utils import set_seed

CPU = torch.device("cpu")
STATE = ("positions", "adam_m", "adam_v", "attract_loss", "repel_loss", "pos_change",
         "num_rep_forces", "overflow")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _adam_by_host_scalars(params, grads, m, v, t, hp):
    """The Adam update as the port computed it before its scalars moved to
    the device: powers of t as host floats in the working dtype."""
    f = np.float64 if params.dtype == torch.float64 else np.float32
    tf = f(t)
    cooling = np.power(f(hp.cooling_factor), tf)
    m = hp.beta1 * m + (1.0 - hp.beta1) * grads
    v = hp.beta2 * v + (1.0 - hp.beta2) * grads * grads
    m_hat = m / float(f(1.0) - np.power(f(hp.beta1), tf))
    v_hat = v / float(f(1.0) - np.power(f(hp.beta2), tf))
    step = float(cooling * f(hp.learning_rate)) * m_hat / (torch.sqrt(v_hat) + float(f(hp.epsilon)))
    return params + step, m, v


def _simple_by_host_scalars(params, grads, t, learning_rate, cooling_factor):
    clipped = torch.clamp(grads, -1.0, 1.0)
    cooling = float(np.power(np.float32(cooling_factor), np.float32(t)))
    return params + learning_rate * cooling * clipped


@pytest.mark.parametrize("kind", [OptimizerType.ADAM, OptimizerType.SIMPLE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schedule_rows_give_the_host_scalar_update(kind, dtype):
    """Tolerance: none.  Every t of 1 ... 1000, the update with the
    schedule's row on the device (here the CPU) is bitwise the update by
    host scalars, state carried from step to step."""
    opts = EmbedderOptions(optimizer_type=kind, learning_rate=10.0, cooling_factor=0.99)
    schedule = optim.Schedule(opts, dtype, CPU)
    hp = optim.AdamParams(opts.learning_rate, opts.cooling_factor)
    rng = np.random.default_rng(3)
    params = torch.as_tensor(rng.normal(size=(64, 3)), dtype=dtype)
    m, v = torch.zeros_like(params), torch.zeros_like(params)
    p_old, m_old, v_old = params, m, v
    for t in range(1, 1001):
        grads = torch.as_tensor(3.0 * rng.normal(size=(64, 3)), dtype=dtype)
        if kind is OptimizerType.ADAM:
            params, m, v = optim.adam_update(params, grads, m, v, schedule.at(t), hp)
            p_old, m_old, v_old = _adam_by_host_scalars(p_old, grads, m_old, v_old, t, hp)
            assert torch.equal(m, m_old) and torch.equal(v, v_old), t
        else:
            params = optim.simple_update(params, grads, schedule.at(t), 10.0, 0.99)
            p_old = _simple_by_host_scalars(p_old, grads, t, 10.0, 0.99)
        assert torch.equal(params, p_old), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_rows_hold_the_reciprocals_aten_multiplies_by(dtype):
    """On a CUDA device ATen divides by a host scalar as a multiply by its
    reciprocal in the tensor's dtype; the card's rows hold exactly those
    reciprocals (tolerance: none), and the same cooled learning rate."""
    f = np.float64 if dtype == torch.float64 else np.float32
    hp = optim.AdamParams(10.0, 0.99)
    for t in range(1, 1001):
        lr_c, c1, c2 = optim.adam_row(t, hp, dtype, CPU)
        lr_g, r1, r2 = optim.adam_row(t, hp, dtype, torch.device("cuda", 0))
        assert lr_g == lr_c and type(r1) is f
        assert r1 == f(1.0) / c1 and r2 == f(1.0) / c2


def _dense_graph():
    """girg10k's shape (a GIRG of average degree 15, d = 2, the dense
    path) at 1,500 vertices: the plain all-pairs pass takes ~12 s a step at
    10,000 vertices on one CPU thread."""
    g, _, _ = generators.girg(1500, dim=2, avg_degree=15, ple=2.5, rng=np.random.default_rng(5))
    return g


def _span_graph():
    g, _, _ = generators.girg(2500, dim=2, avg_degree=10, ple=2.5, rng=np.random.default_rng(7))
    return g


def _embedder(path, graph, replay, **kw):
    set_seed(11)
    mode = RepulsionMode.BUCKET if path == "span" else RepulsionMode.DENSE
    opts = EmbedderOptions(repulsion_mode=mode, **kw)
    emb = WEmbedEmbedder(graph, opts, verbose=False, device="cpu")
    if replay:
        emb._step_graph = step_mod.StepGraph(CPU)
    return emb


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in STATE)


@pytest.mark.parametrize("path", ["dense", "span"])
def test_runner_follows_the_eager_loop_bitwise(path):
    """Tolerance: none.  The runner's loop (eager first step, capture,
    replays into its buffers) against the eager loop from the same seed;
    on the span path across a swap of the windows (every window one tile
    wider after 6 steps), which the captured step survives (it reads the
    windows in place and the sweep takes each step's work items), and the
    growth protocol's segment boundaries (a resize interval of 4)."""
    graph, kw = (_dense_graph(), dict(max_iterations=8)) if path == "dense" else (
        _span_graph(), dict(max_iterations=14, span_resize_interval=4))
    runs = []
    for replay in (False, True):
        emb = _embedder(path, graph, replay, **kw)
        if path == "span":
            emb.calculate_embedding(max_iterations=6)
            emb._swap_index(emb._index.grow_all())
        emb.calculate_embedding()
        runs.append(emb)
    eager, run = runs
    assert run.iteration == eager.iteration == kw["max_iterations"]
    assert _same(run.state, eager.state)
    runner = run._step_graph
    assert runner.captured and run.state.positions is runner._buffers.positions
    assert runner.captures == 1
    assert (run.growth_events, run._shrink_events) == (eager.growth_events, eager._shrink_events)


def _captured(emb, steps=3):
    for _ in range(steps):
        emb.calculate_step()
    assert emb._step_graph.captured
    return emb


@pytest.mark.parametrize("change", ["set_coordinates", "set_weights", "checkpoint"])
def test_assignments_drop_the_captured_step(change, tmp_path):
    """State, weights or windows installed from outside drop the captured
    step; the next step runs eagerly and the one after captures anew, on
    the trajectory of an embedder that was never captured."""
    graph = _span_graph()
    emb = _captured(_embedder("span", graph, True, max_iterations=30))
    ref = _embedder("span", graph, False, max_iterations=30)
    for _ in range(3):
        ref.calculate_step()
    if change == "set_coordinates":
        coords = emb.get_coordinates() * 1.01
        emb.set_coordinates(coords)
        ref.set_coordinates(coords)
    elif change == "set_weights":
        w = emb.get_weights() * 1.5
        emb.set_weights(w)
        ref.set_weights(w)
    else:
        path = str(tmp_path / "ckpt.npz")
        save_checkpoint(path, ref)
        load_checkpoint(path, emb)
        load_checkpoint(path, ref)
    assert not emb._step_graph.captured
    for _ in range(3):
        emb.calculate_step()
        ref.calculate_step()
    assert emb._step_graph.captured and emb._step_graph.captures == 2
    assert _same(emb.state, ref.state)


def test_a_layer_change_frees_the_captured_step():
    """The expansion into a finer layer drops the coarser layer's embedder,
    and with it (no reference cycle holds it) its captured step; the new
    layer captures its own."""
    made = []

    def factory(graph, opts, **kw):
        emb = WEmbedEmbedder(graph, opts, **kw)
        emb._step_graph = step_mod.StepGraph(CPU)
        made.append(weakref.ref(emb))
        return emb

    set_seed(3)
    g, _, _ = generators.girg(600, dim=2, avg_degree=10, ple=2.5, rng=np.random.default_rng(9))
    emb = LayeredEmbedder(g, EmbedderOptions(max_iterations=4), verbose=False, device="cpu",
                          embedder_factory=factory)
    layer = emb.current_layer
    assert layer > 0
    while emb.current_layer == layer:
        emb.calculate_step()
    assert len(made) == 2 and made[0]() is None
    current = made[1]()
    assert current is emb._current and not current._step_graph.captured
    for _ in range(3):
        emb.calculate_step()
    assert current._step_graph.captured


@pytest.mark.parametrize("path", ["dense", "span"])
def test_launch_counts_advance_once_a_step(path, monkeypatch):
    """The wrappers count a launch only on the card; here each wrapper is
    wrapped to count its calls, so that the runner's bookkeeping shows:
    the capture's count taken back, a replay's count added, one launch of
    the path's kernel a step."""
    if path == "dense":
        wrapper, module, name = fused_dense.fused_dense_forces, step_mod, "fused_dense_forces"
    else:
        wrapper, module, name = span_sweep.span_sweep, span_sparse, "span_sweep"

    def counting(*args, **kw):
        out = wrapper(*args, **kw)
        wrapper.launches += 1
        return out

    monkeypatch.setattr(module, name, counting)
    graph = _dense_graph() if path == "dense" else _span_graph()
    emb = _embedder(path, graph, True, max_iterations=30)
    kernel = "fused_dense" if path == "dense" else "span_sweep"
    before = launch_counts()
    for k in range(1, 6):
        emb.calculate_step()
        counts = launch_counts()
        assert counts[kernel] - before[kernel] == k
        assert all(counts[o] == before[o] for o in counts if o != kernel)
    assert emb._step_graph.captures == 1
