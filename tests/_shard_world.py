"""Index-sharded worlds for the port's shard tests: the same arrays behind
the reference's `ShardedSearchEngine(mesh=None)` and the port's.

The data sit on the 1/64 grid (`tests/_quant_grid.py`), so every float32
and ADC distance, norm and error is exact and the two packages must agree
bit for bit. The shard graphs are the reference's
(`build_sharded_graph_index`), carried into the port as arrays. A
quantized world encodes the whole corpus once with one grid codec and cuts
the codes at the shard offsets, which is what the reference's
shared-sample training gives: one codec on every shard.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from repro.core import SearchConfig as JConfig
from repro.core import SearchEngine as JEngine
from repro.core.sharded import ShardedSearchEngine as JSharded
from repro.data import make_dataset as j_make_dataset
from repro.data import make_label_workload as j_label
from repro.index import build_graph_index
from repro.index.builder import build_sharded_graph_index
from repro.quant import codecs as J
from repro.quant.tiering import DeviceVectorStore as JDeviceStore
from _quant_grid import grid_index, grid_queries, on_grid
from repro_torch.convert import engine_from_arrays, state_to_numpy
from repro_torch.core import SearchConfig
from repro_torch.core.sharded import ShardedSearchEngine
from repro_torch.filters import FilterSpec
from repro_torch.quant.tiering import as_vector_store

CFG = SearchConfig(k=5, queue_size=32, pred_kind=0)

REF_BACKEND = {"dense": "dense", "persistent": "pallas_persistent",
               "fused": "pallas"}


def pspec(spec):
    """A reference FilterSpec batch as the port's."""
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


@functools.lru_cache(maxsize=1)
def dataset():
    """The reference tests' shard corpus (512 × 8, 4 clusters, 16 labels),
    on the grid."""
    jds = j_make_dataset(n=512, dim=8, n_clusters=4, alphabet_size=16,
                         seed=0)
    jds.vectors = on_grid(jds.vectors)
    return jds


@functools.lru_cache(maxsize=None)
def sharded_graph(n_shards: int):
    return build_sharded_graph_index(np.asarray(dataset().vectors), n_shards,
                                     degree=8, seed=0)


@functools.lru_cache(maxsize=1)
def plain_graph():
    return build_graph_index(dataset().vectors, degree=8, seed=0)


@functools.lru_cache(maxsize=None)
def grid_codec(precision: str):
    return grid_index(precision, dataset().vectors)


def shard_quants(precision: str, n_shards: int):
    """The global grid codec cut into per-shard indexes (None at
    float32)."""
    if precision == "float32":
        return None
    g = grid_codec(precision)
    ns = len(dataset().vectors) // n_shards
    out = []
    for i in range(n_shards):
        cut = slice(i * ns, (i + 1) * ns)
        if precision == "int8":
            out.append(J.Int8Index(codes=g.codes[cut], scale=g.scale,
                                   zero=g.zero, norms=g.norms[cut],
                                   err=g.err[cut]))
        else:
            out.append(J.PQIndex(codes=g.codes[cut], codebooks=g.codebooks,
                                 norms=g.norms[cut], err=g.err[cut]))
    return out


def ref_sharded(n_shards: int, precision: str = "float32",
                backend: str = "dense") -> JSharded:
    """The reference's loop-path sharded engine over the grid world, laid
    out as `ShardedSearchEngine.build` lays it out."""
    jds = dataset()
    sg = sharded_graph(n_shards)
    quants = shard_quants(precision, n_shards)
    vals = np.asarray(jds.value_matrix)
    shards = []
    for i, g in enumerate(sg.shards):
        lo, hi = int(g.offset), int(g.offset) + g.n
        vec = (jnp.zeros((g.n, 0), jnp.float32) if quants is not None
               else jnp.asarray(jds.vectors[lo:hi]))
        shards.append(JEngine(
            base_vectors=vec, label_attrs=jnp.asarray(jds.labels_packed[lo:hi]),
            value_attrs=jnp.asarray(vals[lo:hi]),
            neighbors=jnp.asarray(g.neighbors), entry_point=int(g.entry_point),
            backend=REF_BACKEND[backend], mesh=None, precision=precision,
            quant=None if quants is None else quants[i]))
    return JSharded(shards=shards, offsets=np.asarray(sg.offsets),
                    entry_points=np.asarray(sg.entry_points),
                    backend=REF_BACKEND[backend], mesh=None,
                    precision=precision,
                    vector_store=(None if quants is None
                                  else JDeviceStore(jds.vectors)))


def port_sharded(n_shards: int, precision: str = "float32",
                 backend: str = "dense", tier: str = "device"):
    """The port's sharded engine over the same arrays, on the CPU: one
    engine per shard graph, a quantized one holding the reference's codes
    of its slice and [Ns, 0] vector placeholders, the float32 rows in a
    `tier` vector store, as `ShardedSearchEngine.build` lays it out."""
    jds = dataset()
    sg = sharded_graph(n_shards)
    quants = shard_quants(precision, n_shards)
    ns = sg.shard_size
    shards = []
    for i, g in enumerate(sg.shards):
        lo, hi = int(g.offset), int(g.offset) + ns
        shards.append(engine_from_arrays(
            np.zeros((ns, 0), np.float32) if quants is not None
            else jds.vectors[lo:hi],
            jds.labels_packed[lo:hi], np.asarray(jds.value_matrix)[lo:hi],
            np.asarray(g.neighbors), g.entry_point, backend=backend,
            device="cpu", precision=precision,
            quant=None if quants is None else quants[i]))
    return ShardedSearchEngine(
        shards=shards, offsets=np.asarray(sg.offsets, np.int32),
        entry_points=np.asarray(sg.entry_points, np.int32), backend=backend,
        precision=precision,
        vector_store=(None if quants is None
                      else as_vector_store(jds.vectors, tier, "cpu")))


def port_plain(precision: str = "float32", backend: str = "dense"):
    """The port's unsharded engine over the reference's plain graph."""
    jds = dataset()
    g = plain_graph()
    return engine_from_arrays(
        jds.vectors, jds.labels_packed, jds.value_matrix,
        np.asarray(g.neighbors), g.entry_point, backend=backend,
        device="cpu", precision=precision,
        quant=None if precision == "float32" else grid_codec(precision))


def workload(batch: int, seed: int, precision: str = "float32"):
    """A contain workload on the grid (int8 queries with coordinate 0 at
    ±127/64, so the int8 ADC is exact)."""
    wl = j_label(dataset(), batch=batch, kind="contain", seed=seed)
    wl.queries = grid_queries(wl.queries, precision)
    return wl


def jcfg(**kw):
    return JConfig(k=5, queue_size=32, pred_kind=0, **kw)


def assert_state_equal(port, ref, where):
    """Every leaf of a port SearchState equals the reference's, dtype and
    bits (visited as uint32)."""
    for name, g, w in zip(port._fields, state_to_numpy(port), ref):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


def assert_sharded_equal(port, ref, where):
    """Every merged and every stacked field of a ShardedSearchState."""
    assert_state_equal(port.merged, ref.merged, f"{where} merged")
    assert_state_equal(port.shard, ref.shard, f"{where} stacked")


def host_merge_res(states, offsets, k):
    """Cross-shard merge of per-shard result pools by a flat lexsort on
    (dist, pos), pos = shard · k + slot."""
    s = len(states)
    b = states[0].res_dist.shape[0]
    dist = np.stack([st.res_dist.numpy() for st in states], axis=1)
    idx = np.stack([st.res_idx.numpy() for st in states], axis=1)
    gidx = np.where(idx >= 0, idx + np.asarray(offsets)[None, :, None], -1)
    pos = np.broadcast_to(
        (np.arange(s)[:, None] * k + np.arange(k))[None], (b, s, k))
    out_d = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    for q in range(b):
        order = np.lexsort((pos[q].ravel(), dist[q].ravel()))[:k]
        out_d[q] = dist[q].ravel()[order]
        out_i[q] = gidx[q].ravel()[order]
    return out_d, out_i


def check_sharded_matches_reference(n_shards, precision, backend):
    """The port's sharded search (probe, then resume; post and widen) ==
    the reference's loop path in every merged and stacked field, and ==
    independent per-shard searches + a host lexsort merge, with merged
    counters the exact sums; under a codec the reranks are equal too."""
    jeng = ref_sharded(n_shards, precision, backend)
    eng = port_sharded(n_shards, precision, backend)
    wl = workload(9, 3, precision)
    spec = pspec(wl.spec)
    for mode in ("post", "widen"):
        cfg = dataclasses.replace(CFG, mode=mode)
        jc = jcfg(mode=mode)
        jst = jeng.search(jc, wl.queries, wl.spec, 60)
        st = eng.search(cfg, wl.queries, spec, 60)
        assert_sharded_equal(st, jst, f"{mode} probe")
        jst = jeng.search(jc, wl.queries, wl.spec, 300, state=jst)
        st = eng.search(cfg, wl.queries, spec, 300, state=st)
        assert_sharded_equal(st, jst, f"{mode} resume")

        parts = [sh.search(cfg, wl.queries, spec, -(-300 // n_shards))
                 for sh in eng.shards]
        direct = eng.search(cfg, wl.queries, spec, 300)
        rd, ri = host_merge_res(parts, eng.offsets, cfg.k)
        np.testing.assert_array_equal(direct.res_dist.numpy(), rd)
        np.testing.assert_array_equal(direct.res_idx.numpy(), ri)
        for f in ("cnt", "n_inspected", "hops", "n_clause_valid"):
            want = sum(getattr(p, f).numpy().astype(np.int64) for p in parts)
            np.testing.assert_array_equal(
                getattr(direct, f).numpy().astype(np.int64), want)
        np.testing.assert_array_equal(
            direct.active.numpy(),
            np.any(np.stack([p.active.numpy() for p in parts]), axis=0))
    if precision != "float32":
        rr, jrr = eng.rerank(CFG, wl.queries, st), jeng.rerank(
            jcfg(), wl.queries, jst)
        np.testing.assert_array_equal(rr.res_idx.numpy(),
                                      np.asarray(jrr.res_idx))
        np.testing.assert_array_equal(rr.res_dist.numpy(),
                                      np.asarray(jrr.res_dist))
