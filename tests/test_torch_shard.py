"""Index-axis sharding in the PyTorch port (`repro_torch.core.sharded`, the
loop path), on the CPU, against the JAX reference.

Counterparts of the 12 tests of `tests/test_shard.py`:

- mesh shapes (`best_search_mesh_shape`, and the rest of
  `distributed/fault_tolerance.py`) equal the reference's;
- a shard graph's validation names the shard; the builder refuses an
  indivisible corpus;
- `merge_stacked` equals the reference's and a host lexsort of the pools
  under (dist, pos), ties included (hypothesis);
- the sharded state equals the reference's `ShardedSearchEngine(mesh=None)`
  in every merged and every stacked field, bit for bit, at S ∈ {1, 2, 4}
  × float32 / int8 / PQ on dense (the persistent cases are in
  `test_torch_shard_persistent.py`, so that the two halves of the matrix
  run in parallel; grid data: every distance is exact,
  `tests/_shard_world.py`), and equals independent per-shard searches
  merged by a host lexsort;
- S = 1 is the plain engine; the sharded scan is the unsharded scan;
  probe → resume equals a direct search;
- the host tier equals the device tier bit for bit, and the device tier
  the reference's device tier (the reference's own host-tier test fails
  on its side and is not the yardstick);
- a float32 traversal on a compressed sharded engine raises, as does a
  mesh (the mesh path needs several GPUs);
- e2e, planner and scheduler on a sharded engine: training data, e2e
  results, EXPLAIN shard sections and `summary()` dicts equal the
  reference's;
- `launch/serve.py::main --shards 2 --device cpu`.

Tolerance: none — every comparison is exact (ids, counters, distance
bits), as the grid data make the arithmetic exact in both packages —
except probe features, within rtol 1e-5 + atol 1e-5 (log1p, sums and
ratios go through different float routines, as in test_torch_e2e.py).
"""
import contextlib
import dataclasses
import io
import itertools
import json

import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, st

import jax
import jax.numpy as jnp

from repro.core import CostEstimator as JEstimator
from repro.core import e2e_search as j_e2e
from repro.core import generate_training_data as j_training
from repro.core.plans import scan_search as j_scan
from repro.distributed import fault_tolerance as JFT
from repro.distributed.merge import merge_stacked as j_merge_stacked
from repro.serve import CostAwareScheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import requests_from_workload as j_requests
import _shard_world as W
from repro_torch.convert import estimator_to_torch
from repro_torch.core import (ShardedSearchEngine, e2e_search,
                              generate_training_data, scan_search)
from repro_torch.core.plans import scan_stats
from repro_torch.data import make_dataset
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.distributed.merge import PAD_POS, merge_stacked
from repro_torch.index import build_sharded_graph_index
from repro_torch.index.graph import GraphIndex, ShardedGraphIndex
from repro_torch.quant import DeviceVectorStore, HostVectorStore
from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                               requests_from_workload)

CFG = W.CFG


@pytest.fixture(autouse=True)
def _drop_jax_executables():
    """Free the reference's compiled programs after each test: a process
    that keeps every one of this file's many shapes has crashed inside
    XLA's compiler."""
    yield
    jax.clear_caches()


# ------------------------------------------------------------- mesh shapes ----
def test_best_search_mesh_shape():
    """Index axis = the largest common divisor of devices and shards, the
    rest to batch; the same shapes as the reference over a grid of counts,
    and the same errors."""
    assert FT.best_search_mesh_shape(6, 4) == ((3, 2), ("data", "index"))
    assert FT.best_search_mesh_shape(7, 4) == ((7, 1), ("data", "index"))
    assert FT.best_search_mesh_shape(8, 4) == ((2, 4), ("data", "index"))
    for d in range(1, 17):
        for s in range(1, 9):
            assert (FT.best_search_mesh_shape(d, s)
                    == JFT.best_search_mesh_shape(d, s))
    for n in (1, 8, 16, 100, 512, 1024):
        assert FT.best_mesh_shape(n) == JFT.best_mesh_shape(n)
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            FT.best_search_mesh_shape(*bad)


def test_step_monitor_and_clamp_budgets_match_reference():
    durations = [1.0] * 10 + [5.0, 1.0, 0.9, 4.0]
    mon, jmon = FT.StepMonitor(), JFT.StepMonitor()
    for i, dt in enumerate(durations):
        ev, jev = mon.observe(i, dt), jmon.observe(i, dt)
        assert (ev is None) == (jev is None)
        if ev is not None:
            assert dataclasses.astuple(ev) == dataclasses.astuple(jev)
    budgets = np.random.default_rng(0).integers(32, 5000, 64)
    for q in (0.5, 0.95):
        got, want = FT.clamp_budgets(budgets, q), JFT.clamp_budgets(budgets, q)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# --------------------------------------------------------- graph validation ----
def test_graph_validate_names_offending_shard():
    """A neighbor id ≥ n_s in a shard slice is a cross-shard edge: the
    error carries the shard ordinal and its global rows."""
    nb = torch.zeros((8, 2), dtype=torch.int32)
    nb[0] = torch.tensor([1, 2])
    nb[1:, 0] = 0
    nb[1:, 1] = -1
    nb[5] = torch.tensor([9, -1])
    g = GraphIndex(neighbors=nb, entry_point=0, dim=4, shard=2, offset=16)
    with pytest.raises(ValueError) as ei:
        g.validate()
    msg = str(ei.value)
    assert "shard 2" in msg and "[16, 24)" in msg and "global 21" in msg
    # a misordered shard list is refused too
    ok = GraphIndex(neighbors=nb.clone()[:, :1].clamp(max=0), entry_point=1,
                    dim=4, shard=1, offset=0)
    with pytest.raises(ValueError, match="order"):
        ShardedGraphIndex(shards=[ok]).validate()


def test_sharded_graph_builder_rejects_indivisible():
    ds = make_dataset(n=130, dim=8, n_clusters=2, alphabet_size=8, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        build_sharded_graph_index(ds.vectors, 4, degree=4, seed=0,
                                  device="cpu")
    sg = build_sharded_graph_index(ds.vectors[:128], 4, degree=4, seed=0,
                                   device="cpu")
    assert sg.n == 128 and sg.n_shards == 4
    np.testing.assert_array_equal(sg.offsets, [0, 32, 64, 96])


# ---------------------------------------------------------- merge property ----
def _pools(b, w, s, seed):
    """Sorted per-shard pools [B, S, W] with distances from 4 values (ties
    are the norm) and inf pads (payload -1), as part-filled pools hold."""
    rng = np.random.default_rng(seed)
    dists = rng.integers(0, 4, (b, s, w)).astype(np.float32)
    dists[rng.random((b, s, w)) < 0.2] = np.inf
    dists = np.sort(dists, axis=2)
    pays = rng.integers(0, 1000, (b, s, w)).astype(np.int32)
    pays[np.isinf(dists)] = -1
    return dists, pays


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.integers(1, 8), st.integers(1, 6),
       st.integers(1, 12), st.integers(0, 2**31 - 1))
def test_merge_stacked_matches_host_lexsort(b, w, s, m, seed):
    """The port's cross-shard merge == a flat host lexsort of the
    concatenated pools under (dist, pos), ties included."""
    dists, pays = _pools(b, w, s, seed)
    m = min(m, s * w)
    d, p, o = (t.numpy() for t in merge_stacked(
        torch.from_numpy(dists), torch.from_numpy(pays), m))
    pos = np.broadcast_to(
        (np.arange(s)[:, None] * w + np.arange(w))[None], (b, s, w))
    fd, fo = dists.reshape(b, -1), np.ascontiguousarray(pos.reshape(b, -1))
    fp = pays.reshape(b, -1)
    for i in range(b):
        order = np.lexsort((fo[i], fd[i]))[:m]
        np.testing.assert_array_equal(d[i], fd[i][order])
        np.testing.assert_array_equal(o[i], fo[i][order])
        np.testing.assert_array_equal(p[i], fp[i][order])
    assert (o < PAD_POS).all()


@pytest.mark.parametrize("b,w,s,m", [(1, 1, 1, 1), (3, 5, 3, 7),
                                     (4, 8, 4, 12), (2, 6, 5, 30)])
def test_merge_stacked_matches_reference(b, w, s, m):
    """The port's merge == the reference's `merge_stacked`: distance bits,
    payloads and positions (a few shapes: each is a JAX compilation)."""
    dists, pays = _pools(b, w, s, seed=b * 1000 + w * 100 + s * 10 + m)
    got = merge_stacked(torch.from_numpy(dists), torch.from_numpy(pays), m)
    want = j_merge_stacked(jnp.asarray(dists), jnp.asarray(pays), m)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(x).view(np.uint32))


# ------------------------------------------------------------ parity matrix ----
# the persistent cases are in test_torch_shard_persistent.py
@pytest.mark.parametrize("backend", ["dense"])
@pytest.mark.parametrize("precision", ["float32", "int8", "pq"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_matches_reference(n_shards, precision, backend):
    """The port's sharded search (probe, then resume; post and widen) ==
    the reference's loop path in every merged and stacked field, and ==
    independent per-shard searches + a host lexsort merge, with merged
    counters the exact sums."""
    W.check_sharded_matches_reference(n_shards, precision, backend)


def test_single_shard_engine_is_the_plain_engine():
    """S=1: a one-shard sharded engine is bit for bit the unsharded one
    (a merge of one pool is the identity), in every merged field but the
    bitset's width, and its one shard is the plain state."""
    plain = W.port_plain()
    wl = W.workload(9, 3)
    spec = W.pspec(wl.spec)
    # the same graph: the plain engine's, as a one-shard index
    shard1 = ShardedSearchEngine(
        shards=[plain], offsets=np.zeros(1, np.int32),
        entry_points=np.asarray([plain.entry_point], np.int32))
    for backend in ("dense", "persistent"):
        cfg = dataclasses.replace(CFG, backend=backend)
        a = plain.search(cfg, wl.queries, spec, 400)
        b = shard1.search(cfg, wl.queries, spec, 400)
        for f, x, y in zip(a._fields, a, b.merged):
            assert torch.equal(x, y), (backend, f)
        for f, x, y in zip(a._fields, a, b.shard):
            assert torch.equal(x, y[:, 0]), (backend, f)


@pytest.mark.parametrize("precision", ["float32", "int8", "pq"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_scan_matches_unsharded(n_shards, precision):
    """The scan plan is an exact filtered brute force: sharding changes
    neither its results nor its NDC, at any precision; and the sharded
    scan equals the reference's sharded scan in every merged field but
    `n_clause_valid`'s per-shard rounding (compared too: it is the
    reference's rounding)."""
    plain = W.port_plain(precision)
    eng = W.port_sharded(n_shards, precision)
    jeng = W.ref_sharded(n_shards, precision)
    wl = W.workload(9, 3, precision)
    spec = W.pspec(wl.spec)
    a = scan_search(plain, CFG, wl.queries, spec)
    b = scan_search(eng, CFG, wl.queries, spec)
    for f in ("res_dist", "res_idx", "cnt", "cand_dist", "cand_idx"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    jb = j_scan(jeng, W.jcfg(), wl.queries, wl.spec)
    W.assert_sharded_equal(b, jb, "scan")
    stats = scan_stats(eng, eng.compile(spec))
    jstats = jeng.scan_stats(jeng.compile(wl.spec))
    np.testing.assert_array_equal(stats.valid.numpy(), np.asarray(jstats.valid))
    np.testing.assert_array_equal(stats.counts, jstats.counts)
    np.testing.assert_array_equal(stats.clause_frac.view(np.uint32),
                                  jstats.clause_frac.view(np.uint32))
    assert stats.n == eng.n == jstats.n


def test_probe_resume_parity():
    """probe → resume on the sharded engine == one direct search at the
    final budget (resume exactness across shards), every merged field."""
    eng = W.port_sharded(2)
    wl = W.workload(9, 3)
    spec = W.pspec(wl.spec)
    for backend in ("dense", "persistent", "fused"):
        cfg = dataclasses.replace(CFG, backend=backend)
        direct = eng.search(cfg, wl.queries, spec, 400)
        st = eng.search(cfg, wl.queries, spec, 60)
        st = eng.search(cfg, wl.queries, spec, 400, state=st)
        for f, x, y in zip(direct.merged._fields, direct.merged, st.merged):
            assert torch.equal(x, y), (backend, f)


# ----------------------------------------------------------------- tiering ----
def test_host_tier_rerank_bitwise_matches_device_tier():
    """The same compressed traversal and the same exact float32 rerank
    whether the rerank's rows live on the device or in host memory; and
    the device tier equals the reference's device tier."""
    wl = W.workload(9, 3, "int8")
    spec = W.pspec(wl.spec)
    outs = {}
    for tier in ("device", "host"):
        eng = W.port_sharded(2, "int8", tier=tier)
        assert eng.vector_store.kind == tier
        assert all(sh.base_vectors.shape[1] == 0 for sh in eng.shards)
        st = eng.search(CFG, wl.queries, spec, 300)
        outs[tier] = eng.rerank(CFG, wl.queries, st)
    for f in ("res_idx", "res_dist"):
        assert torch.equal(getattr(outs["device"], f),
                           getattr(outs["host"], f)), f
    jeng = W.ref_sharded(2, "int8")
    jst = jeng.rerank(W.jcfg(), wl.queries,
                      jeng.search(W.jcfg(), wl.queries, wl.spec, 300))
    np.testing.assert_array_equal(outs["device"].res_idx.numpy(),
                                  np.asarray(jst.res_idx))
    np.testing.assert_array_equal(outs["device"].res_dist.numpy(),
                                  np.asarray(jst.res_dist))


def test_vector_stores_gather_the_same_rows():
    """Both tiers gather the same bytes (negative ids read row 0); a plain
    engine built with tier="host" keeps
    an [N, 0] placeholder and reranks to the device tier's bits."""
    from repro_torch.core import SearchEngine
    from repro_torch.index.graph import GraphIndex as PGraph

    rng = np.random.default_rng(0)
    vec = rng.standard_normal((300, 12)).astype(np.float32)
    idx = torch.from_numpy(rng.integers(-1, 300, (5, 37)).astype(np.int32))
    dev = DeviceVectorStore(vec, "cpu")
    host = HostVectorStore(vec, "cpu")
    assert host.nbytes == dev.nbytes == vec.nbytes and host.shape == (300, 12)
    assert torch.equal(dev.gather(idx), host.gather(idx))
    assert torch.equal(host.gather(idx)[idx < 0][:, 0],
                       torch.from_numpy(vec[0, :1]).expand(
                           int((idx < 0).sum())))

    jds = W.dataset()
    g = W.plain_graph()
    graph = PGraph(neighbors=torch.from_numpy(np.asarray(g.neighbors)),
                   entry_point=g.entry_point, dim=8)
    ds = make_dataset(n=512, dim=8, n_clusters=4, alphabet_size=16, seed=0)
    ds.vectors = jds.vectors
    engines = {t: SearchEngine.build(ds, graph, device="cpu",
                                     precision="int8", tier=t,
                                     quant_cfg={"train_sample_size": 256})
               for t in ("device", "host")}
    assert engines["host"].base_vectors.shape == (512, 0)
    assert engines["device"].vector_store is None
    wl = W.workload(6, 5, "int8")
    spec = W.pspec(wl.spec)
    res = {}
    for t, e in engines.items():
        st = e.search(CFG, wl.queries, spec, 200)
        res[t] = e.rerank(CFG, wl.queries, st)
    assert torch.equal(res["device"].res_idx, res["host"].res_idx)
    assert torch.equal(res["device"].res_dist, res["host"].res_dist)
    with pytest.raises(ValueError, match="float32 traversal"):
        engines["host"].search(dataclasses.replace(CFG, precision="float32"),
                               wl.queries, spec, 100)
    with pytest.raises(ValueError, match="tier='host'"):
        SearchEngine.build(ds, graph, device="cpu", tier="host")


def test_float32_traversal_on_compressed_engine_raises():
    eng = W.port_sharded(2, "int8", tier="host")
    wl = W.workload(4, 1, "int8")
    cfg = dataclasses.replace(CFG, precision="float32")
    with pytest.raises(ValueError, match="float32 traversal"):
        eng.search(cfg, wl.queries, W.pspec(wl.spec), 100)


def test_build_and_its_refusals():
    """`ShardedSearchEngine.build` over the port's own shard graphs: the
    codecs of every shard share their parameters (one sample), the shards
    of a float32 build view one tensor, and the reference's ValueErrors
    (host tier at float32, a graph of another size) plus a mesh, which
    waits for several GPUs, are refused."""
    ds = make_dataset(n=256, dim=8, n_clusters=4, alphabet_size=16, seed=0)
    sg = build_sharded_graph_index(ds.vectors, 2, degree=8, seed=0,
                                   device="cpu")
    eng = ShardedSearchEngine.build(ds, sg, device="cpu")
    v0, v1 = (sh.base_vectors for sh in eng.shards)
    assert v1.data_ptr() == v0.data_ptr() + v0.numel() * 4
    q = ShardedSearchEngine.build(ds, sg, device="cpu", precision="int8",
                                  quant_cfg={"train_sample_size": 64})
    a, b = (sh.quant for sh in q.shards)
    assert torch.equal(a.scale, b.scale) and torch.equal(a.zero, b.zero)
    assert q.codec_key() == q.shards[1].codec_key()
    cat = q.quant_concat
    assert cat.codes.shape == (256, 8) and torch.equal(cat.codes[128:],
                                                       b.codes)
    assert q.label_attrs.shape == (256, ds.n_words)
    assert q.value_attrs.shape == (256, ds.n_value_attrs)
    with pytest.raises(ValueError, match="tier='host'"):
        ShardedSearchEngine.build(ds, sg, device="cpu", tier="host")
    with pytest.raises(ValueError, match="covers"):
        ShardedSearchEngine.build(
            make_dataset(n=258, dim=8, n_clusters=4, alphabet_size=16,
                         seed=0), sg, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ShardedSearchEngine.build(ds, sg, device="cpu", mesh="auto")
    assert eng.tier == q.tier == "device" and eng.vector_store is None
    h = ShardedSearchEngine.build(ds, sg, device="cpu", precision="int8",
                                  tier="host",
                                  quant_cfg={"train_sample_size": 64})
    assert h.tier == "host" and h.vector_store.shape == (256, 8)


# -------------------------------------------------- e2e / planner / serve ----
def _clock():
    """An injected clock that advances one unit a read."""
    c = itertools.count()
    return lambda: float(next(c))


def test_e2e_planner_serve_on_sharded_engine():
    """The adaptive pipeline on a sharded engine, held to the reference's:
    training data (features, W_q, ground truth), e2e_search with EXPLAIN
    (results, budgets, every report, shard sections included), the
    planner's ScanStats, and the scheduler's service and summary."""
    jds = W.dataset()
    jeng = W.ref_sharded(2, backend="persistent")
    eng = W.port_sharded(2, backend="persistent")
    assert eng.n_shards == 2 and eng.is_sharded
    wl = W.workload(9, 3)
    spec = W.pspec(wl.spec)
    jtd = j_training(jeng, jds, wl, W.jcfg(), probe_budget=32, chunk=16)
    pds = make_dataset(n=512, dim=8, n_clusters=4, alphabet_size=16, seed=0)
    pds.vectors = jds.vectors
    pwl = dataclasses.replace(wl, spec=spec)
    td = generate_training_data(eng, pds, pwl, CFG, probe_budget=32,
                                chunk=16)
    np.testing.assert_array_equal(td.w_q, jtd.w_q)
    np.testing.assert_array_equal(td.converged, jtd.converged)
    np.testing.assert_array_equal(td.gt_dist, jtd.gt_dist)
    # features within 1e-5: the packages evaluate log1p, sums and ratios
    # with different float routines (as in tests/test_torch_e2e.py)
    np.testing.assert_allclose(td.features, jtd.features, rtol=1e-5,
                               atol=1e-5)
    jest = JEstimator.fit(jtd.features, jtd.w_q, n_trees=8, depth=3)
    est = estimator_to_torch(jest)

    jres = j_e2e(jeng, jest, W.jcfg(), wl.queries, wl.spec, probe_budget=32,
                 explain=True)
    res = e2e_search(eng, est, CFG, wl.queries, spec, probe_budget=32,
                     explain=True)
    np.testing.assert_array_equal(res.predicted_budget, jres.predicted_budget)
    W.assert_sharded_equal(res.state, jres.state, "e2e")
    for r, jr in zip(res.reports, jres.reports):
        d, jd = r.to_dict(), jr.to_dict()
        jd["backend"] = d["backend"]   # "persistent" / "pallas_persistent"
        f, jf = d.pop("features"), jd.pop("features")
        assert d == jd and list(f) == list(jf)
        np.testing.assert_allclose(list(f.values()), list(jf.values()),
                                   rtol=1e-5, atol=1e-5)
        assert len(r.shards) == 2 and r.merge_depth == 1
    cnt, bud = res.state.cnt.numpy(), res.predicted_budget
    active = res.state.active.numpy()
    assert np.all(cnt >= 1) and np.all(cnt[active] >= bud[active])

    stats = scan_stats(eng, eng.compile(spec))
    assert stats.n == eng.n and stats.valid.shape[1] == eng.n

    scfg = ServeConfig(lane_width=4, probe_budget=32, alpha=1.5,
                       buckets=(128, None), cache_capacity=0)
    # injected clocks that advance one unit a read: both schedulers read
    # them at the same points, so their summaries must agree
    sched = CostAwareScheduler(eng, est, CFG, scfg, timer=_clock())
    jsched = JScheduler(jeng, jest, W.jcfg(), JServeConfig(
        **dataclasses.asdict(scfg)), timer=_clock())
    assert sched.summary()["n_shards"] == 2
    reqs, jreqs = requests_from_workload(pwl), j_requests(wl)
    for sch, rs in ((sched, reqs), (jsched, jreqs)):
        for r in rs:
            assert sch.submit(r, 0.0) == "queued"
        sch.run_until_idle(0.0)
    for r, jr in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.res_idx, np.asarray(jr.res_idx))
        np.testing.assert_array_equal(r.res_dist, np.asarray(jr.res_dist))
        assert (r.ndc, r.budget, r.n_slices) == (jr.ndc, jr.budget,
                                                 jr.n_slices)
    assert sched.summary() == jsched.summary()
    assert sum(sched.summary()["shards"]["ndc_by_shard"]) == sum(
        r.ndc for r in reqs)


def test_serve_launcher_with_shards_on_cpu():
    """`python -m repro_torch.launch.serve --shards 2 --device cpu`: the
    corpus rounds up to a multiple of S, the engine is sharded, and the
    health report and scrape carry the per-shard counters."""
    from repro_torch.launch import serve
    from repro_torch.obs import validate_prometheus

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sched = serve.main(["--device", "cpu", "--shards", "2", "--corpus",
                            "1001", "--requests", "16", "--train-queries",
                            "64", "--status", "--prometheus"])
    text = out.getvalue()
    assert "index-axis sharded: 2 shards x 501 rows" in text
    assert sched.engine.n == 1002 and sched.summary()["n_shards"] == 2
    health = json.loads(text.split("== serving health\n", 1)[1].split(
        "== prometheus scrape")[0])
    assert health["summary"]["shards"]["n_shards"] == 2
    assert sum(health["summary"]["shards"]["ndc_by_shard"]) == sum(
        r["ndc"] for r in sched.metrics.records if not r["cache_hit"])
    names = validate_prometheus(text.split("== prometheus scrape\n", 1)[1])
    assert names["repro_shard_ndc_total"] == 2
