"""Search-state parity of the PyTorch port against the JAX reference.

Same data, same graph (built by the reference and carried across), same
filters: the port's `SearchState` with backend "dense" and "fused" must
equal the reference's "dense" and "pallas" states after `init_state`,
after the probe and after the resume — every int/bool leaf exactly
(`visited` as uint32 bit patterns), float leaves to 1e-5 (the packages
sum distances in different orders).

The vectors and queries sit on the grid 1/64, so every squared distance
is exact in float32 whatever the summation order: the comparison pins the
algorithm (tie order included), not the order of float additions. With
unrounded data a near-tie at the queue boundary (two distances 2e-7
apart) can fall either way between the packages.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import SearchEngine as JEngine
from repro.core.state import SearchConfig as JConfig, init_state as j_init
from repro.data import make_dataset, make_label_workload, make_range_workload
from repro.index import build_graph_index
from repro_torch.convert import (engine_from_arrays, state_to_numpy,
                                 state_to_torch)
from repro_torch.core import SearchConfig, SearchEngine, init_state
from repro_torch.filters import FilterSpec
from repro_torch.index.graph import GraphIndex

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
PAIRS = [("dense", "dense"), ("fused", "pallas")]


def on_grid(a):
    return (np.round(a * 64) / 64).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    ds = make_dataset(n=2000, dim=16, n_clusters=6, alphabet_size=32, seed=0)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(ds.vectors, degree=8, seed=0)
    jeng = JEngine.build(ds, graph, mesh=None)
    eng = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                             graph.neighbors, graph.entry_point, device="cpu")
    return ds, graph, jeng, eng


def _workload(ds, kind):
    if kind == "range":
        wl = make_range_workload(ds, batch=8, seed=4)
    else:
        wl = make_label_workload(ds, batch=8, kind="contain", seed=3)
    wl.queries = on_grid(wl.queries)
    return wl


def pspec(spec):
    """The reference's FilterSpec as the port's (same arrays)."""
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


def assert_state_equal(port_state, ref_state, where):
    got = state_to_numpy(port_state)
    for name, g, w in zip(port_state._fields, got, ref_state):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
        if w.dtype == np.float32:
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w),
                                          err_msg=f"{where}: {name}")
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{where}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


@pytest.mark.parametrize("kind", ["contain", "range"])
def test_init_state_matches_reference(world, kind):
    ds, graph, jeng, eng = world
    wl = _workload(ds, kind)
    cfg = SearchConfig(k=5, queue_size=32, degree=8)
    jcfg = JConfig(k=5, queue_size=32, degree=8)
    ref = j_init(jcfg, jnp.asarray(wl.queries), jeng.compile(wl.spec),
                 jeng.base_vectors, jeng._attrs(), graph.entry_point)
    got = init_state(cfg, torch.from_numpy(wl.queries),
                     eng.compile(pspec(wl.spec)),
                     eng.base_vectors, (eng.label_attrs, eng.value_attrs),
                     graph.entry_point)
    assert_state_equal(got, ref, "init")


@pytest.mark.parametrize("kind", ["contain", "range"])
@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_probe_and_resume_match_reference(world, kind, backend, ref_backend):
    ds, _, jeng, eng = world
    wl = _workload(ds, kind)
    jcfg = JConfig(k=5, queue_size=32, backend=ref_backend)
    cfg = SearchConfig(k=5, queue_size=32, backend=backend)
    budgets = np.linspace(20, 60, wl.batch).astype(np.int32)
    ref = jeng.search(jcfg, wl.queries, wl.spec, budgets)
    got = eng.search(cfg, wl.queries, pspec(wl.spec), budgets)
    assert_state_equal(got, ref, "probe")
    resume = budgets * 8
    ref = jeng.search(jcfg, wl.queries, wl.spec, resume, state=ref)
    got = eng.search(cfg, wl.queries, pspec(wl.spec), resume, state=got)
    assert_state_equal(got, ref, "resume")
    assert (np.asarray(ref.cnt) > budgets).any()


def test_resume_from_carried_reference_state(world):
    """A reference probe state carried across resumes to the reference's
    result (the converter round-trips every leaf, visited bits included)."""
    ds, _, jeng, eng = world
    wl = _workload(ds, "contain")
    jcfg = JConfig(k=5, queue_size=32, backend="dense")
    ref = jeng.search(jcfg, wl.queries, wl.spec, 40)
    carried = state_to_torch([np.asarray(a) for a in ref], device="cpu")
    assert_state_equal(carried, ref, "carried")
    ref = jeng.search(jcfg, wl.queries, wl.spec, 300, state=ref)
    got = eng.search(SearchConfig(k=5, queue_size=32, backend="fused"),
                     wl.queries, pspec(wl.spec), 300, state=carried)
    assert_state_equal(got, ref, "resume")


def test_visited_repeated_id_carries_like_reference(world):
    """A neighbor id repeated in one row sets its visited bit twice: the
    reference's wrapping uint32 add carries into the next bit, and so
    does the port's int32 scatter-add."""
    ds, graph, jeng, _ = world
    nbrs = graph.neighbors.copy()
    nbrs[:, 1] = nbrs[:, 0]                       # every row repeats an id
    g2 = type(graph)(neighbors=nbrs, entry_point=graph.entry_point,
                     dim=graph.dim)
    jeng2 = JEngine.build(ds, g2, mesh=None)
    eng2 = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                              nbrs, graph.entry_point, device="cpu")
    wl = _workload(ds, "contain")
    jcfg = JConfig(k=5, queue_size=32, backend="dense")
    ref = jeng2.search(jcfg, wl.queries, wl.spec, 30)
    got = eng2.search(SearchConfig(k=5, queue_size=32), wl.queries,
                      pspec(wl.spec), 30)
    assert_state_equal(got, ref, "repeated ids")


PRODUCERS = ["init", "scan", "planned"] + [
    f"{mode}/{backend}" for mode in ("post", "pre", "widen", "int8", "pq")
    for backend in ("dense", "fused", "persistent")]


def _planner():
    """A small port planner: heads fitted to random labels, so lanes go
    to more than one plan."""
    from repro_torch.core.estimator import CostEstimator
    from repro_torch.core.features import N_FEATURES
    from repro_torch.core.planner import STATIC_FEATURE_NAMES, Planner

    rng = np.random.default_rng(0)
    fit = lambda f, lo, hi: CostEstimator.fit(  # noqa: E731
        rng.random((64, f)).astype(np.float32), rng.integers(lo, hi, 64),
        n_trees=4, depth=2)
    return Planner(traverse=fit(N_FEATURES, 50, 400),
                   widen=fit(N_FEATURES, 50, 400),
                   static=fit(len(STATIC_FEATURE_NAMES), 20, 60),
                   scan_floor=64)


@pytest.mark.parametrize("producer", PRODUCERS)
def test_states_keep_buffers_sorted(world, producer):
    """`cand_dist` and `res_dist` are non-decreasing in every lane of every
    SearchState the port produces — init_state, probe and resume on each
    backend (plain versions here), pre and widen, the scan, the planner,
    the int8 and PQ engines. K1/K3/K4 and K5 merge by rank and rely on
    it."""
    from repro_torch.core.planner import planned_search
    from repro_torch.core.plans import scan_search
    from repro_torch.quant import build_quant_index

    ds, graph, _, eng = world
    wl = _workload(ds, "contain")
    filt = pspec(wl.spec)
    cfg = SearchConfig(k=5, queue_size=32)
    states = []
    if producer == "init":
        for kind in ("contain", "range"):
            w = _workload(ds, kind)
            states.append(init_state(
                cfg, torch.from_numpy(w.queries), eng.compile(pspec(w.spec)),
                eng.base_vectors, (eng.label_attrs, eng.value_attrs),
                graph.entry_point))
    elif producer == "scan":
        states.append(scan_search(eng, cfg, wl.queries, filt))
    elif producer == "planned":
        res = planned_search(eng, _planner(), cfg, wl.queries, filt,
                             probe_budget=32)
        assert len(set(res.plan.tolist())) >= 2
        states.append(res.state)
    else:
        mode, backend = producer.split("/")
        if mode in ("int8", "pq"):
            quant = build_quant_index(mode, ds.vectors, device="cpu",
                                      pq_subspaces=4, pq_centroids=16,
                                      pq_iters=4)
            eng = engine_from_arrays(ds.vectors, ds.labels_packed,
                                     ds.value_matrix, graph.neighbors,
                                     graph.entry_point, device="cpu",
                                     precision=mode, quant=quant)
            mode = "post"
        cfg = SearchConfig(k=5, queue_size=32, mode=mode, backend=backend)
        budgets = np.linspace(20, 60, wl.batch).astype(np.int32)
        states.append(eng.search(cfg, wl.queries, filt, budgets))
        states.append(eng.search(cfg, wl.queries, filt, budgets * 8,
                                 state=states[-1]))
    for st in states:
        for name in ("cand_dist", "res_dist"):
            d = getattr(st, name)
            assert bool((d[:, 1:] >= d[:, :-1]).all()), (producer, name)
        assert torch.isfinite(st.cand_dist[:, 0]).any(), producer


def test_post_mode_only():
    """Post mode is no longer the only mode under a codec: pre and widen
    build a step at int8 and PQ too (their states against the reference:
    tests/test_torch_quant_plan.py), and a mode that does not exist still
    raises under either precision."""
    from repro_torch.core.step import make_step

    for precision in ("int8", "pq", "float32"):
        for mode in ("post", "pre", "widen"):
            step = make_step(SearchConfig(mode=mode, precision=precision),
                             None, None, None, None, (None, None), None,
                             None, None)
            assert callable(step)
        with pytest.raises(ValueError, match="unknown traversal mode"):
            make_step(SearchConfig(mode="bogus", precision=precision), None,
                      None, None, None, (None, None), None, None, None)


def test_build_without_device_needs_cuda(world, monkeypatch):
    ds, graph, _, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = GraphIndex(neighbors=torch.from_numpy(graph.neighbors),
                   entry_point=graph.entry_point, dim=graph.dim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine.build(ds, g)
    eng = SearchEngine.build(ds, g, device="cpu")
    assert eng.device.type == "cpu"


def test_port_imports_without_jax_or_repro():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.index, repro_torch.data, repro_torch.filters\n"
        "import repro_torch.kernels.fused_step, repro_torch.kernels.gbdt\n"
        "import repro_torch.kernels.persistent_step\n"
        "import repro_torch.kernels.distance\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.quant", "repro_torch.quant.tiering", "repro_torch.kernels",
    "repro_torch.core", "repro_torch.distributed", "repro_torch.obs",
    "repro_torch.serve", "repro_torch.index", "repro_torch.launch.serve"])
def test_each_module_imports_first(module):
    """Each entry module imports in a fresh process, before any other of
    the port's: no import cycle depends on which module a caller loads
    first."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
