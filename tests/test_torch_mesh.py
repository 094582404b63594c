"""The search meshes of the PyTorch port on the CPU: `SearchEngine`'s 1-D
batch mesh, `ShardedSearchEngine`'s 2-D ("data", "index") mesh and the
butterfly merge, held to the loop path and to the JAX reference.

A port mesh may list one device more than once (the stated departure of
`repro_torch/distributed/sharding.py`), so `[cpu] × D` runs every line of
the mesh code here, with the kernels' plain versions:

- `bitonic_merge_phase` and `merge_sorted_pools` equal the reference's bit
  for bit (ties, inf pads, widths that are no power of two);
- `butterfly_merge` equals `merge_stacked` over all pools at D ∈ {1, 2,
  3, 4, 8} (the XOR butterfly and the gather);
- `search_mesh_2d` takes the reference's shapes
  (`best_search_mesh_shape`) and is None on one device;
- the batch mesh at D = 4 on B = 13 lanes (padded to 16), fused and
  persistent, probe and probe → resume: every leaf equals the unmeshed
  run and the reference's `mesh=None` run (its one shot for the resume),
  and `dispatch_counters` do not move;
- the 2-D mesh at (1, 4), (2, 2), (4, 1) × float32 / int8, and PQ at
  (2, 2): every per-shard and merged leaf equals the loop path (the
  probe, and probe → resume against one shot; post and widen). The same
  meshes are held to the
  reference's loop path in the S = 4 cases of
  `test_torch_shard.py` / `test_torch_shard_persistent.py`, beside the
  reference runs those cases already make;
- `e2e_search` on a mesh engine equals it on the loop engine (budgets,
  every leaf, EXPLAIN reports); the builds and their refusals; the
  mesh's "shard-search" span.

Tolerance: none — the grid data (`tests/_shard_world.py`) make every
distance exact.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.distributed import fault_tolerance as JFT
from repro.distributed.merge import merge_sorted_pools as j_merge_pools
from repro.distributed.sharding import search_mesh_2d as j_search_mesh_2d
from repro.kernels.topk import bitonic_merge_phase as j_bitonic
import _shard_world as W
from repro_torch.core import (CostEstimator, SearchEngine,
                              ShardedSearchEngine, dispatch_counters,
                              e2e_search, generate_training_data,
                              make_search_mesh)
from repro_torch.data import make_dataset
from repro_torch.distributed import (PAD_POS, Mesh, butterfly_merge,
                                     merge_plan, merge_sorted_pools,
                                     merge_stacked, pool_positions,
                                     search_mesh_2d)
from repro_torch.index import build_graph_index, build_sharded_graph_index
from repro_torch.kernels.topk import bitonic_merge_phase
from repro_torch.obs import Tracer

CFG = W.CFG
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny searches' torch ops on one thread: under the suite's
    parallel workers, each worker's default of one thread a core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the merges ----
def _sorted_pool(rng, b, w, pos_pool):
    """A pool [B, w] sorted by (dist, pos): distances from 4 values (ties
    are the norm) and inf pads (payload −1), positions drawn without
    replacement from `pos_pool`."""
    d = rng.integers(0, 4, (b, w)).astype(np.float32)
    d[rng.random((b, w)) < 0.25] = np.inf
    o = np.stack([rng.choice(pos_pool, w, replace=False) for _ in range(b)])
    order = np.lexsort((o, d), axis=1)
    d, o = np.take_along_axis(d, order, 1), np.take_along_axis(o, order, 1)
    p = rng.integers(0, 1000, (b, w)).astype(np.int32)
    p[np.isinf(d)] = -1
    return d, p, o.astype(np.int32)


@pytest.mark.parametrize("b,wa,wb,m", [(1, 1, 1, 1), (3, 5, 4, 5),
                                       (2, 12, 12, 12), (4, 10, 7, 9)])
def test_bitonic_merge_matches_reference(b, wa, wb, m):
    """`merge_sorted_pools` and the phase under it equal the reference's
    bit for bit: distances, payloads, positions, with ties and inf pads.
    The reference's functions run under `jax.jit` (one compilation a
    shape; a compare-exchange network moves values and computes none)."""
    rng = np.random.default_rng(b * 100 + wa * 10 + wb)
    da, pa, oa = _sorted_pool(rng, b, wa, np.arange(0, 64, 2))
    db, pb, ob = _sorted_pool(rng, b, wb, np.arange(1, 64, 2))
    got = merge_sorted_pools(*map(torch.from_numpy, (da, pa, oa, db, pb, ob)),
                             m)
    want = jax.jit(j_merge_pools, static_argnames="m")(
        *map(jnp.asarray, (da, pa, oa, db, pb, ob)), m=m)
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert g.numpy().dtype == x.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      x.view(np.uint32))
    # the phase alone on a bitonic block with one payload lane
    w = 1 << (wa + wb - 1).bit_length()
    pad = w - wa - wb
    keys = np.concatenate([da, np.full((b, pad), np.inf, np.float32),
                           db[:, ::-1]], axis=1)
    pos = np.concatenate([oa, np.full((b, pad), PAD_POS, np.int32),
                          ob[:, ::-1]], axis=1)
    lane = rng.integers(-5, 5, (b, w)).astype(np.int32)
    k, o, (ln,) = bitonic_merge_phase(torch.from_numpy(keys),
                                      torch.from_numpy(pos),
                                      (torch.from_numpy(lane),))
    jk, jo, (jl,) = jax.jit(j_bitonic)(jnp.asarray(keys), jnp.asarray(pos),
                                       (jnp.asarray(lane),))
    np.testing.assert_array_equal(k.numpy().view(np.uint32),
                                  np.asarray(jk).view(np.uint32))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_butterfly_merge_equals_merge_stacked(n_dev):
    """Each of D positions merges its 2 local shards on the global
    position space (`shard0`), then `butterfly_merge` joins them: every
    position ends with `merge_stacked` of all 2·D pools, bit for bit —
    the XOR butterfly at D = 2, 4, 8, the gather at D = 3, unchanged at
    D = 1 — and `merge_stacked(pos=)` is the host lexsort on (dist,
    pos)."""
    rng = np.random.default_rng(n_dev)
    nloc, b, w = 2, 3, 6
    s = nloc * n_dev
    dists = np.sort(rng.integers(0, 4, (b, s, w)).astype(np.float32), 2)
    dists[:, :, -2:] = np.inf
    pays = rng.integers(0, 10_000, (b, s, w)).astype(np.int32)
    pays[np.isinf(dists)] = -1
    d_all, p_all = torch.from_numpy(dists), torch.from_numpy(pays)
    for m in (5, w, w * nloc + 1):
        want = merge_stacked(d_all, p_all, m)
        local = [merge_stacked(d_all[:, i * nloc:(i + 1) * nloc],
                               p_all[:, i * nloc:(i + 1) * nloc], m,
                               shard0=i * nloc) for i in range(n_dev)]
        got = butterfly_merge(local, m, [CPU] * n_dev)
        assert len(got) == n_dev
        for pool in got:
            for g, x in zip(pool, want):
                assert g.dtype == x.dtype and torch.equal(g, x), (m, n_dev)
    pos = pool_positions(w, 0, s, b)
    flat_d = dists.reshape(b, -1)
    shuffled = torch.from_numpy(rng.permutation(s * w).astype(np.int32))
    perm_pos = shuffled[pos.reshape(b, -1).long()].reshape(b, s, w)
    d, p, o = merge_stacked(d_all, p_all, 7, pos=perm_pos)
    for i in range(b):
        order = np.lexsort((perm_pos[i].reshape(-1).numpy(), flat_d[i]))[:7]
        np.testing.assert_array_equal(d[i].numpy(), flat_d[i][order])
        np.testing.assert_array_equal(o[i].numpy(),
                                      perm_pos[i].reshape(-1).numpy()[order])
        np.testing.assert_array_equal(p[i].numpy(),
                                      pays.reshape(b, -1)[i][order])


# ---------------------------------------------------------- mesh shapes ----
def test_search_mesh_shapes():
    """`search_mesh_2d` takes the reference's (data, index) shapes at 4 and
    7 devices with S = 4 and is None on one device (so is the reference's
    on this host's one device); `make_search_mesh` is 1-D; the defaults
    count only cards, each once, so a host without one gives None."""
    for n in (1, 4, 7):
        mesh = search_mesh_2d(4, [CPU] * n)
        if n == 1:
            assert mesh is None
            continue
        shape, names = JFT.best_search_mesh_shape(n, 4)
        assert mesh.axis_names == names == ("data", "index")
        assert tuple(mesh.shape.values()) == shape and mesh.size == n
        assert mesh.distinct == [CPU] and mesh.first == CPU
    assert j_search_mesh_2d(4) is None
    assert search_mesh_2d(4) is None and make_search_mesh() is None
    assert make_search_mesh([CPU]) is None
    m = make_search_mesh(["cpu"] * 3)
    assert m.shape == {"data": 3} and list(m.grid("data")) == [CPU] * 3
    g = W.cpu_mesh(2, 3).grid("index", "data")
    assert g.shape == (3, 2)
    with pytest.raises(ValueError, match="axis names"):
        Mesh([CPU, CPU], ("data", "index"))
    with pytest.raises(ValueError, match="lack"):
        m.grid("index")


# ------------------------------------------------------------ batch mesh ----
@functools.lru_cache(maxsize=1)
def _batch_reference():
    """The reference's unsharded mesh=None run on B = 13 lanes: the probe
    at 60 and one shot at 300 (numpy leaves; one compilation); shared by
    the fused and the persistent cases (the reference's backends agree
    bit for bit)."""
    jeng = W.ref_plain("dense")
    wl = W.workload(13, 4)
    jc = W.jcfg()
    return tuple([np.asarray(x) for x in jeng.search(jc, wl.queries, wl.spec,
                                                     budget)]
                 for budget in (60, 300))


@pytest.mark.parametrize("backend", ["fused", "persistent"])
def test_batch_mesh_matches_unmeshed(backend):
    """`SearchEngine` on a 4-position batch mesh, 13 lanes (3 pad lanes):
    the probe, and the probe resumed on the mesh, equal the unmeshed run
    and the reference's mesh=None run (its one shot: probe → resume ≡ one
    shot) in every leaf; the mesh runs `run_search` on each slice, so
    `dispatch_counters` do not move."""
    plain = W.port_plain(backend=backend)
    mesh = W.on_mesh(plain, (4,))
    wl = W.workload(13, 4)
    spec = W.pspec(wl.spec)
    ref_probe, ref_one = _batch_reference()
    want_probe = plain.search(CFG, wl.queries, spec, 60)
    d0 = dispatch_counters()
    got = mesh.search(CFG, wl.queries, spec, 60)
    W.assert_state_equal(got, ref_probe, "mesh probe")
    for f, x, y in zip(got._fields, got, want_probe):
        assert x.dtype == y.dtype and torch.equal(x, y), ("probe", f)
    got = mesh.search(CFG, wl.queries, spec, 300, state=got)
    assert dispatch_counters() == d0
    assert list(mesh._replicas) == [CPU]
    W.assert_state_equal(got, ref_one, "mesh resume")
    want = plain.search(CFG, wl.queries, spec, 300, state=want_probe)
    for f, x, y in zip(want._fields, want, got):
        assert x.dtype == y.dtype and torch.equal(x, y), ("resume", f)


# --------------------------------------------------------------- 2-D mesh ----
@functools.lru_cache(maxsize=None)
def _loop_engine(precision):
    return W.port_sharded(4, precision, "fused")


@functools.lru_cache(maxsize=None)
def _loop_runs(precision):
    """The loop path's probe (40) and one shot (160) in post and widen
    mode — shared by the mesh shapes of one precision."""
    eng = _loop_engine(precision)
    wl = W.workload(9, 3, precision)
    spec = W.pspec(wl.spec)
    out = {}
    for mode in ("post", "widen"):
        cfg = dataclasses.replace(CFG, mode=mode)
        out[mode] = (eng.search(cfg, wl.queries, spec, 40),
                     eng.search(cfg, wl.queries, spec, 160))
    return out


@pytest.mark.parametrize("shape,precision", [
    *((s, p) for p in ("float32", "int8") for s in W.MESH_SHAPES),
    ((2, 2), "pq")])
def test_sharded_mesh_matches_loop_path(shape, precision):
    """The 2-D mesh path (local shards, the merge on the global position
    space, the butterfly over the index axis, the batch cut over the data
    axis with 9 lanes padded where it does not divide) equals the loop
    path in every per-shard and merged leaf, post and widen, fused
    backend: the probe equals the loop's probe, and the probe resumed on
    the mesh equals the loop's one shot (probe → resume ≡ one shot)."""
    mesh = W.on_mesh(_loop_engine(precision), shape)
    wl = W.workload(9, 3, precision)
    spec = W.pspec(wl.spec)
    for mode, (probe, one) in _loop_runs(precision).items():
        cfg = dataclasses.replace(CFG, mode=mode)
        st = mesh.search(cfg, wl.queries, spec, 40)
        W.assert_port_sharded_equal(st, probe, f"{mode} probe")
        st = mesh.search(cfg, wl.queries, spec, 160, state=st)
        W.assert_port_sharded_equal(st, one, f"{mode} resume")
    assert mesh._stacked is not None   # the mesh path ran, not the loop


def test_e2e_on_mesh_equals_loop():
    """`e2e_search` (probe, K2 budgets, resume; EXPLAIN) on a (2, 2) mesh
    engine equals it on the loop engine: budgets, every leaf, reports —
    but the stages' launch counts, which read `dispatch_counters`: the
    mesh runs `run_search` and moves none, as in the reference."""
    eng = W.port_sharded(2, backend="persistent")
    wl = W.workload(9, 3)
    spec = W.pspec(wl.spec)
    ds = make_dataset(n=512, dim=8, n_clusters=4, alphabet_size=16, seed=0)
    ds.vectors = W.dataset().vectors
    td = generate_training_data(eng, ds, dataclasses.replace(wl, spec=spec),
                                CFG, probe_budget=32, chunk=16)
    est = CostEstimator.fit(td.features, td.w_q, n_trees=8, depth=3)
    want = e2e_search(eng, est, CFG, wl.queries, spec, probe_budget=32,
                      alpha=1.5, explain=True)
    got = e2e_search(W.on_mesh(eng, (2, 2)), est, CFG, wl.queries, spec,
                     probe_budget=32, alpha=1.5, explain=True)
    np.testing.assert_array_equal(got.predicted_budget, want.predicted_budget)
    W.assert_port_sharded_equal(got.state, want.state, "e2e")
    for r, w in zip(got.reports, want.reports):
        r, w = r.to_dict(), w.to_dict()
        assert [st.pop("launches") for st in r["stages"]] == [0] * len(
            r["stages"])
        assert sum(st.pop("launches") for st in w["stages"]) > 0
        assert r == w


# ---------------------------------------------------- builds, refusals ----
def test_mesh_builds_and_refusals():
    """Both builds take an explicit mesh (the engine on its first entry,
    the index placed once on the one repeated device: no copy) and
    "auto" (None on the CPU); a sharded mesh without "index" or "data",
    an index axis that does not divide S, a device that is not the mesh's
    first and a mesh given as another string are refused."""
    ds = make_dataset(n=256, dim=8, n_clusters=4, alphabet_size=16, seed=0)
    sg = build_sharded_graph_index(ds.vectors, 2, degree=8, seed=0,
                                   device="cpu")
    eng = ShardedSearchEngine.build(ds, sg, device="cpu",
                                    mesh=W.cpu_mesh(2, 2))
    assert eng.mesh.shape == {"data": 2, "index": 2} and eng.device == CPU
    assert sorted(eng._stacked) == [(0, 1, CPU), (1, 1, CPU)]
    for (lo, _, _), local in eng._stacked.items():
        assert local[0][0].data_ptr() == eng.shards[lo].base_vectors.data_ptr()
    assert ShardedSearchEngine.build(ds, sg, device="cpu").mesh is None
    for bad, what in ((W.cpu_mesh(4, names=("data",)), "lacks"),
                      (W.cpu_mesh(1, 4, names=("index", "model")), "lacks"),
                      (W.cpu_mesh(1, 4), "does not divide"),
                      ("everywhere", "mesh must be")):
        with pytest.raises(ValueError, match=what):
            ShardedSearchEngine.build(ds, sg, device="cpu", mesh=bad)
    graph = build_graph_index(ds.vectors, degree=8, seed=0, device="cpu")
    plain = SearchEngine.build(ds, graph, mesh=make_search_mesh([CPU] * 4))
    assert plain.mesh.size == 4 and plain.device == CPU
    assert list(plain._replicas) == [CPU]
    assert plain._replicas[CPU][0].data_ptr() == plain.base_vectors.data_ptr()
    assert SearchEngine.build(ds, graph, device="cpu").mesh is None
    with pytest.raises(ValueError, match="first entry"):
        SearchEngine.build(ds, graph, device="meta",
                           mesh=make_search_mesh([CPU] * 2))
    with pytest.raises(ValueError, match="mesh must be"):
        SearchEngine.build(ds, graph, device="cpu", mesh="everywhere")
    wl = W.workload(5, 2)
    spec = W.pspec(wl.spec)
    a = eng.search(CFG, wl.queries, spec, 200)
    b = dataclasses.replace(eng, mesh=None).search(CFG, wl.queries, spec,
                                                   200)
    W.assert_port_sharded_equal(a, b, "built mesh")


def test_mesh_span_attributes():
    """A search on a mesh engine is one "shard-search" span with shard=-1,
    n_shards, pairwise, depth and path="mesh" (the reference's
    attributes), no per-shard or "shard-merge" span; tracing changes no
    leaf."""
    eng = W.on_mesh(W.port_sharded(2, backend="persistent"), (2, 2))
    wl = W.workload(9, 3)
    spec = W.pspec(wl.spec)
    tr = Tracer()
    traced = eng.search(CFG, wl.queries, spec, 200, tracer=tr, trace_id="q")
    W.assert_port_sharded_equal(traced, eng.search(CFG, wl.queries, spec,
                                                   200), "traced")
    (sp,) = tr.spans(name="shard-search")
    pairwise, depth = merge_plan(2)
    assert sp.attrs == {"shard": -1, "n_shards": 2, "pairwise": pairwise,
                        "depth": depth, "path": "mesh"}
    assert not tr.spans(name="shard-merge") and not tr.spans(name="launch")
