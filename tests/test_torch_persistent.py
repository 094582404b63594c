"""The persistent backend (kernel K5) and the dense backend's K6 distance
in the PyTorch port, held to the JAX reference on the CPU.

- K5's plain version against the reference kernel in Pallas interpret
  mode, at the micro shapes of `tests/test_persistent.py`, every
  `SearchState` field equal.
- The port's "persistent" backend against the reference's
  "pallas_persistent" through both engines: every field equal, and the
  launch loop's dispatch counters (launches, compactions, steps) equal, across
  steps_per_launch, max_steps, greedy_stop, probe → resume and
  cross-backend resume.
- `e2e_search` with the persistent backend against the reference's, on a
  carried GBDT model: equal budgets, top-k ids and NDC.
- The dense backend with `use_pallas=True` against the reference's.
- The int8 and PQ branches: K5's plain version against the reference
  kernel in interpret mode, and the "persistent" backend against
  "pallas_persistent" with the dispatch counter deltas, on the exact
  quantized data of `tests/_quant_grid.py` (every field equal).

Vectors and queries sit on the grid 1/64, so every squared distance is
exact in float32 whatever the summation order, and float leaves are
required equal too (see tests/test_torch_search.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (BIG_BUDGET, CostEstimator as JEstimator,
                        SearchConfig as JConfig, SearchEngine as JEngine,
                        e2e_search as j_e2e, generate_training_data)
from repro.core.search import dispatch_counters as j_dispatch_counters
from repro.data import make_dataset, make_label_workload, make_range_workload
from repro.index import build_graph_index
from repro_torch.convert import (engine_from_arrays, gbdt_from_arrays,
                                 program_to_torch, state_to_numpy,
                                 state_to_torch)
from repro_torch.core import (CostEstimator, SearchConfig, dispatch_counters,
                              e2e_search, put_lanes, take_lanes)
from repro_torch.filters import FilterSpec
from repro_torch.kernels.persistent_step import (persistent_multi_step,
                                                 persistent_multi_step_plain)
from repro_torch.quant.codecs import prepare_query
from _quant_grid import grid_index, grid_queries


def on_grid(a):
    return (np.round(a * 64) / 64).astype(np.float32)


def pspec(spec):
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


def assert_fields_equal(port_state, ref_state, where):
    """Every leaf equal, float leaves included (grid data)."""
    for name, g, w in zip(port_state._fields, state_to_numpy(port_state),
                          ref_state):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


# ------------------------------------------ K5 plain vs reference kernel ----
def _micro(rng):
    """The micro world of tests/test_persistent.py (grid vectors), with
    every 4th neighbor row repeating an id (visited add-carry)."""
    n, dim, r, b = 256, 8, 8, 8
    vecs = on_grid(rng.normal(size=(n, dim)))
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int32)
    self_loop = nbrs == np.arange(n)[:, None]
    nbrs[self_loop] = (nbrs[self_loop] + 1) % n
    nbrs[::4, 1] = nbrs[::4, 0]
    labels = rng.integers(0, 2 ** 16, size=(n, 1)).astype(np.uint32)
    values = rng.random((n, 1)).astype(np.float32)
    queries = on_grid(rng.normal(size=(b, dim)))
    budgets = rng.integers(20, 120, size=(b,)).astype(np.int32)
    return vecs, nbrs, labels, values, queries, budgets


@pytest.mark.parametrize("case", ["gt", "greedy", "rem"])
def test_persistent_plain_matches_reference_kernel(case):
    """persistent_multi_step_plain (and the CPU wrapper) == the reference
    kernel in interpret mode: with gt_dist, with greedy_stop, and with
    rem < steps."""
    from repro.core.state import init_state as j_init
    from repro.filters.compile import compile_spec
    from repro.filters.predicates import PRED_RANGE
    from repro.filters import FilterSpec as JSpec
    from repro.kernels.persistent_step import (build_persistent_operands,
                                               persistent_multi_step as j_k5)

    rng = np.random.default_rng(0)
    vecs, nbrs, labels, values, queries, budgets = _micro(rng)
    b, k, m, u = queries.shape[0], 4, 8, 6
    gt = None
    if case == "gt":  # half the lanes covered once their result set fills
        gt = np.sort(rng.random((b, k)), axis=1).astype(np.float32) * 4
        gt[::2] = 1e4
    rem = 3 if case == "rem" else 10 ** 6
    spec = JSpec(PRED_RANGE, None, np.full(b, 0.2, np.float32),
                 np.full(b, 0.9, np.float32))
    prog_np = compile_spec(spec, 1)
    jprog = type(prog_np)(*(jnp.asarray(a) for a in prog_np))
    jcfg = JConfig(k=k, queue_size=m, degree=nbrs.shape[1], mode="post",
                   greedy_stop=case == "greedy")
    st0 = j_init(jcfg, jnp.asarray(queries), jprog, jnp.asarray(vecs),
                 (jnp.asarray(labels), jnp.asarray(values)), 0)
    rows, aux = build_persistent_operands("float32", jnp.asarray(vecs),
                                          jnp.asarray(labels),
                                          jnp.asarray(values), None)
    want = j_k5(jcfg, jnp.asarray(queries), jprog, rows, aux,
                jnp.asarray(nbrs), jnp.asarray(budgets), st0,
                jnp.int32(rem), None if gt is None else jnp.asarray(gt),
                None, steps=u, n_values=1, has_gt=gt is not None,
                interpret=True, block_b=4)

    cfg = SearchConfig(k=k, queue_size=m, degree=nbrs.shape[1],
                       greedy_stop=case == "greedy")
    t = torch.from_numpy
    args = (cfg, t(queries), program_to_torch(prog_np, "cpu"), t(vecs),
            (t(labels.view(np.int32)), t(values)), t(nbrs), t(budgets))
    gt_t = None if gt is None else t(gt)
    leaves = [np.asarray(a) for a in st0]
    got = persistent_multi_step_plain(*args, state_to_torch(leaves, "cpu"),
                                      rem, gt_t, steps=u)
    assert_fields_equal(got, want, f"plain ({case})")
    got = persistent_multi_step(*args, state_to_torch(leaves, "cpu"), rem,
                                gt_t, steps=u)
    assert_fields_equal(got, want, f"wrapper ({case})")
    assert int(np.asarray(want.hops).max()) == min(u, rem)
    if case == "gt":
        assert (np.asarray(want.conv_cnt) > 0).any()
    if case == "greedy":
        assert not np.asarray(want.active).all()


# ------------------------------------------- the backend, end to end ----
@pytest.fixture(scope="module")
def world():
    ds = make_dataset(n=2000, dim=16, n_clusters=6, alphabet_size=32, seed=0)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(ds.vectors, degree=8, seed=0)
    jeng = JEngine.build(ds, graph, mesh=None)
    eng = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                             graph.neighbors, graph.entry_point, device="cpu")
    wl = make_label_workload(ds, batch=13, kind="contain", seed=3)
    wl.queries = on_grid(wl.queries)
    budgets = np.random.default_rng(0).integers(40, 900, size=13)
    return ds, jeng, eng, wl, budgets.astype(np.int32)


def _both(world, budgets, state=None, ref_state=None, **cfg):
    """One search through each engine with the persistent backend;
    returns (port state, reference state, port counter deltas, reference
    counter deltas)."""
    _, jeng, eng, wl, _ = world
    j0, p0 = j_dispatch_counters(), dispatch_counters()
    ref = jeng.search(JConfig(k=5, queue_size=32, backend="pallas_persistent",
                              **cfg), wl.queries, wl.spec, budgets,
                      state=ref_state)
    got = eng.search(SearchConfig(k=5, queue_size=32, backend="persistent",
                                  **cfg), wl.queries, pspec(wl.spec),
                     budgets, state=state)
    jd = {key: v - j0[key] for key, v in j_dispatch_counters().items()}
    pd = {key: v - p0[key] for key, v in dispatch_counters().items()}
    return got, ref, pd, jd


@pytest.mark.parametrize("spl", [1, 3, 8, 64])
def test_persistent_matches_reference_steps_per_launch(world, spl):
    got, ref, pd, jd = _both(world, world[4], steps_per_launch=spl)
    assert_fields_equal(got, ref, f"spl={spl}")
    assert pd == jd, (pd, jd)
    assert pd["launches"] > 0


@pytest.mark.parametrize("max_steps", [1, 5, 17])
def test_persistent_max_steps_cutoff_matches_reference(world, max_steps):
    got, ref, pd, jd = _both(world, BIG_BUDGET, max_steps=max_steps)
    assert_fields_equal(got, ref, f"max_steps={max_steps}")
    assert pd == jd, (pd, jd)
    assert pd["steps"] == max_steps


def test_persistent_greedy_stop_matches_reference(world):
    got, ref, pd, jd = _both(world, BIG_BUDGET, greedy_stop=True)
    assert_fields_equal(got, ref, "greedy")
    assert pd == jd, (pd, jd)


def test_persistent_probe_resume_equals_one_shot(world):
    """A probe to 120 resumed to 700 == a one-shot 700, in the port and
    against the reference's probe → resume."""
    one, ref_one, _, _ = _both(world, 700)
    assert_fields_equal(one, ref_one, "one-shot")
    st, ref_st, _, _ = _both(world, 120)
    got, ref, pd, jd = _both(world, 700, state=st, ref_state=ref_st)
    assert_fields_equal(got, ref, "resumed")
    assert_fields_equal(got, ref_one, "resumed vs one-shot")
    assert pd == jd, (pd, jd)


def test_fused_persistent_cross_backend_resume(world):
    """fused probe → persistent resume, and the reverse, == one-shot."""
    _, _, eng, wl, _ = world
    spec = pspec(wl.spec)
    cf = SearchConfig(k=5, queue_size=32, backend="fused")
    cp = dataclasses.replace(cf, backend="persistent")
    one = eng.search(cf, wl.queries, spec, 700)
    ref_one = [np.asarray(a) for a in state_to_numpy(one)]
    for first, second in ((cp, cf), (cf, cp)):
        st = eng.search(first, wl.queries, spec, 120)
        st = eng.search(second, wl.queries, spec, 700, state=st)
        assert_fields_equal(st, ref_one, f"{first.backend}→{second.backend}")


def test_dense_use_pallas_matches_reference(world):
    """The dense backend with its distances through K6 == the reference's
    dense backend with use_pallas=True, probe and resume."""
    _, jeng, eng, wl, budgets = world
    jcfg = JConfig(k=5, queue_size=32, backend="dense", use_pallas=True)
    cfg = SearchConfig(k=5, queue_size=32, backend="dense", use_pallas=True)
    ref = jeng.search(jcfg, wl.queries, wl.spec, budgets // 4)
    got = eng.search(cfg, wl.queries, pspec(wl.spec), budgets // 4)
    assert_fields_equal(got, ref, "probe")
    ref = jeng.search(jcfg, wl.queries, wl.spec, budgets, state=ref)
    got = eng.search(cfg, wl.queries, pspec(wl.spec), budgets, state=got)
    assert_fields_equal(got, ref, "resume")


def test_take_put_lanes_roundtrip_with_duplicates(world):
    """take_lanes → put_lanes restores every leaf, duplicate (padded)
    indices included; None passes through."""
    _, _, eng, wl, budgets = world
    st = eng.search(SearchConfig(k=5, queue_size=32), wl.queries,
                    pspec(wl.spec), budgets // 4)
    keep = [t.clone() for t in st]
    sel = np.array([2, 5, 11, 2, 2])
    sub, sub_q, none = take_lanes((st, torch.from_numpy(wl.queries), None),
                                  sel)
    assert none is None and sub_q.shape[0] == 5
    for a, s in zip(keep, sub):
        assert torch.equal(a[torch.from_numpy(sel)], s)
    zeroed = type(st)(*(torch.zeros_like(t) for t in st))
    out = put_lanes(zeroed, sub, sel)
    assert out is zeroed
    for a, o in zip(keep, out):
        assert torch.equal(a[[2, 5, 11]], o[[2, 5, 11]])
        assert not o[[0, 1]].any()


# ------------------------------------------------------- e2e_search ----
@pytest.fixture(scope="module")
def e2e_world(world):
    ds, jeng, eng, _, _ = world
    wl = make_label_workload(ds, batch=64, kind="contain", seed=10)
    wl.queries = on_grid(wl.queries)
    td = generate_training_data(jeng, ds, wl, JConfig(k=5, queue_size=32),
                                probe_budget=32, chunk=64)
    jest = JEstimator.fit(td.features, td.w_q, n_trees=30, depth=4,
                          min_child=5)
    m = jest.model
    est = CostEstimator(gbdt_from_arrays(m.feat, m.thresh, m.leaf, m.base,
                                         m.depth, m.importances))
    return jest, est


@pytest.mark.parametrize("kind", ["contain", "range"])
def test_e2e_persistent_matches_reference(world, e2e_world, kind):
    ds, jeng, eng, _, _ = world
    jest, est = e2e_world
    if kind == "range":
        wl = make_range_workload(ds, batch=13, seed=21)
    else:
        wl = make_label_workload(ds, batch=13, kind="contain", seed=20)
    wl.queries = on_grid(wl.queries)
    ref = j_e2e(jeng, jest, JConfig(k=5, queue_size=32,
                                    backend="pallas_persistent"),
                wl.queries, wl.spec, probe_budget=32)
    got = e2e_search(eng, est, SearchConfig(k=5, queue_size=32,
                                            backend="persistent"),
                     wl.queries, pspec(wl.spec), probe_budget=32)
    np.testing.assert_array_equal(got.predicted_budget,
                                  np.asarray(ref.predicted_budget))
    np.testing.assert_allclose(got.probe_features,
                               np.asarray(ref.probe_features), rtol=1e-5,
                               atol=1e-5)
    assert_fields_equal(got.state, ref.state, f"e2e {kind}")


# ------------------------------------------ K5's int8 and PQ branches ----
@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_persistent_plain_matches_reference_kernel_codecs(precision):
    """persistent_multi_step_plain (and the CPU wrapper) == the reference
    kernel in interpret mode under int8 and PQ (the reference's own case,
    tests/test_persistent.py::test_persistent_kernel_interpret_parity, on
    exact data): every field, q_err_sum included."""
    from repro.core.state import init_state as j_init
    from repro.filters import FilterSpec as JSpec
    from repro.filters.compile import compile_spec
    from repro.filters.predicates import PRED_RANGE
    from repro.kernels.persistent_step import (build_persistent_operands,
                                               persistent_multi_step as j_k5)
    from repro.quant.codecs import prepare_query as j_prepare
    from repro_torch.convert import qprep_to_torch, quant_to_torch

    rng = np.random.default_rng(0)
    vecs, nbrs, labels, values, queries, budgets = _micro(rng)
    queries = grid_queries(queries, precision)
    b, k, m, u = queries.shape[0], 4, 8, 6
    gt = np.sort(rng.random((b, k)), axis=1).astype(np.float32) * 4
    gt[::2] = 1e4
    quant = grid_index(precision, vecs, pq_subspaces=4, pq_centroids=16,
                       pq_levels=2)
    qprep = j_prepare(precision, quant, jnp.asarray(queries))
    spec = JSpec(PRED_RANGE, None, np.full(b, 0.2, np.float32),
                 np.full(b, 0.9, np.float32))
    prog_np = compile_spec(spec, 1)
    jprog = type(prog_np)(*(jnp.asarray(a) for a in prog_np))
    jcfg = JConfig(k=k, queue_size=m, degree=nbrs.shape[1], mode="post",
                   precision=precision)
    st0 = j_init(jcfg, jnp.asarray(queries), jprog, jnp.asarray(vecs),
                 (jnp.asarray(labels), jnp.asarray(values)), 0, quant=quant,
                 qprep=qprep)
    rows, aux = build_persistent_operands(precision, jnp.asarray(vecs),
                                          jnp.asarray(labels),
                                          jnp.asarray(values), quant)
    want = j_k5(jcfg, jnp.asarray(queries), jprog, rows, aux,
                jnp.asarray(nbrs), jnp.asarray(budgets), st0,
                jnp.int32(10 ** 6), jnp.asarray(gt), qprep, steps=u,
                n_values=1, has_gt=True, interpret=True, block_b=4)

    cfg = SearchConfig(k=k, queue_size=m, degree=nbrs.shape[1],
                       precision=precision)
    t = torch.from_numpy
    pq, pp = quant_to_torch(quant, "cpu"), qprep_to_torch(qprep, "cpu")
    args = (cfg, t(queries), program_to_torch(prog_np, "cpu"), t(vecs),
            (t(labels.view(np.int32)), t(values)), t(nbrs), t(budgets))
    leaves = [np.asarray(a) for a in st0]
    for fn in (persistent_multi_step_plain, persistent_multi_step):
        got = fn(*args, state_to_torch(leaves, "cpu"), 10 ** 6, t(gt),
                 steps=u, quant=pq, qprep=pp)
        assert_fields_equal(got, want, f"{fn.__name__} ({precision})")
    assert (np.asarray(want.q_err_sum) > np.asarray(st0.q_err_sum)).any()
    assert (np.asarray(want.conv_cnt) > 0).any()
    # the port's own prep of the same queries is the reference's
    mine = prepare_query(precision, pq, t(queries))
    for g, w in zip(mine, qprep):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def quant_world(world):
    """Reference and port engines per codec over the world's grid data,
    sharing one exact quant index."""
    ds, jeng, _, _, _ = world
    graph_nb, ep = np.array(jeng.neighbors), jeng.entry_point
    out = {}
    for precision in ("int8", "pq"):
        jq = dataclasses.replace(jeng, precision=precision,
                                 quant=grid_index(precision, ds.vectors))
        eng = engine_from_arrays(ds.vectors, ds.labels_packed,
                                 ds.value_matrix, graph_nb, ep, device="cpu",
                                 precision=precision, quant=jq.quant)
        wl = make_label_workload(ds, batch=13, kind="contain", seed=3)
        wl.queries = grid_queries(wl.queries, precision)
        out[precision] = (jq, eng, wl)
    return out


@pytest.mark.parametrize("spl", [1, 8])
@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_persistent_codecs_match_reference(world, quant_world, precision,
                                           spl):
    """"persistent" == "pallas_persistent" under int8 and PQ, probe and
    resume: every field and the dispatch counter deltas."""
    jeng, eng, wl = quant_world[precision]
    budgets = world[4]
    jcfg = JConfig(k=5, queue_size=32, backend="pallas_persistent",
                   steps_per_launch=spl)
    cfg = SearchConfig(k=5, queue_size=32, backend="persistent",
                       steps_per_launch=spl)
    ref, got = None, None
    for bud in (budgets // 4, budgets):
        j0, p0 = j_dispatch_counters(), dispatch_counters()
        ref = jeng.search(jcfg, wl.queries, wl.spec, bud, state=ref)
        got = eng.search(cfg, wl.queries, pspec(wl.spec), bud, state=got)
        jd = {key: v - j0[key] for key, v in j_dispatch_counters().items()}
        pd = {key: v - p0[key] for key, v in dispatch_counters().items()}
        assert_fields_equal(got, ref, f"{precision} spl={spl} budget")
        assert pd == jd and pd["launches"] > 0, (pd, jd)
    assert pd["compactions"] > 0
    fused = eng.search(dataclasses.replace(cfg, backend="fused"),
                       wl.queries, pspec(wl.spec), budgets)
    assert_fields_equal(got, state_to_numpy(fused), "persistent vs fused")
