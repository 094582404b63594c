"""The quantized domain of the PyTorch port (int8 and PQ codecs, compressed
traversal, exact rerank) held to the JAX reference on the CPU, at the size
of `tests/test_quant.py` (N=2000, d=24, pq_subspaces=8, pq_centroids=32).

- Codec arrays: trained from the same sample, `codes` and int8 `scale`/
  `zero` equal; norms, err and codebooks to rtol 1e-6 (sums in another
  order); with carried-over parameters, codes and `qq`/`sq` equal, norms,
  err, `qn` and the LUT to rtol 1e-6, `codec_key` equal.
- `compressed_filtered_topk` and `exact_rerank`.
- Every `SearchState` field after init, probe and resume for the port's
  dense and fused backends against the reference's dense and pallas, in
  int8 and PQ, on grid data; e2e budgets, top-k ids after the rerank and
  NDC; training labels with the compressed convergence target.

Grid data (`tests/_quant_grid.py`): every ADC distance, norm and error
is exact in float32 whatever the summation order, so every float field
of the state is required equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (CostEstimator as JEstimator, SearchConfig as JConfig,
                        SearchEngine as JEngine, e2e_search as j_e2e,
                        generate_training_data as j_training)
from repro.core.state import init_state as j_init
from repro.data import make_dataset, make_label_workload, make_range_workload
from repro.index import build_graph_index
from repro.quant import codecs as J
from repro.quant import exact_rerank as j_rerank
from _quant_grid import grid_index, grid_queries, on_grid
from repro_torch.convert import (engine_from_arrays, gbdt_from_arrays,
                                 qprep_to_torch, quant_to_numpy,
                                 quant_to_torch, state_to_numpy)
from repro_torch.core import (CostEstimator, SearchConfig, e2e_search,
                              generate_training_data, init_state)
from repro_torch.data.synthetic import QueryWorkload
from repro_torch.filters import FilterSpec
from repro_torch.quant import codecs as P
from repro_torch.quant import exact_rerank

QCFG = dict(pq_subspaces=8, pq_centroids=32, pq_iters=8)
PAIRS = [("dense", "dense"), ("fused", "pallas")]
RTOL = 1e-6


def pspec(spec):
    return FilterSpec(spec.kind, spec.label_masks, spec.range_lo,
                      spec.range_hi)


def assert_fields_equal(port_state, ref_state, where):
    for name, g, w in zip(port_state._fields, state_to_numpy(port_state),
                          ref_state):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")


# ------------------------------------------------------------ codecs ----
@pytest.fixture(scope="module")
def float_world():
    ds = make_dataset(n=2000, dim=24, n_clusters=6, alphabet_size=32, seed=0)
    sample = ds.sample_vectors(16384, seed=0)
    refs = {p: J.build_quant_index(p, ds.vectors, train_sample=sample, **QCFG)
            for p in ("int8", "pq")}
    return ds, sample, refs


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_codec_training_matches_reference(float_world, precision):
    """Trained from the same sample: codes (and int8 scale/zero) equal,
    float leaves to rtol 1e-6. The PQ codebooks start from the reference's
    numpy draws."""
    ds, sample, refs = float_world
    ref = refs[precision]
    got = P.build_quant_index(precision, torch.from_numpy(ds.vectors),
                              train_sample=sample, device="cpu", **QCFG)
    assert type(got).__name__ == type(ref).__name__
    for name, g, w in zip(got._fields, quant_to_numpy(got), ref):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ("codes", "scale", "zero"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_build_quant_index_device_rule(float_world, monkeypatch, precision):
    """The codec is built on the card unless the caller asks for the CPU:
    numpy input with `device="cpu"` gives CPU tensors equal to those from
    a CPU tensor input; with no card and no `device` the call raises."""
    ds, sample, _ = float_world
    got = P.build_quant_index(precision, ds.vectors, train_sample=sample,
                              device="cpu", **QCFG)
    want = P.build_quant_index(precision, torch.from_numpy(ds.vectors),
                               train_sample=torch.from_numpy(sample),
                               device="cpu", **QCFG)
    for name, g, w in zip(got._fields, got, want):
        assert g.device.type == "cpu", name
        assert torch.equal(g, w), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_quant_index(precision, ds.vectors, train_sample=sample,
                            **QCFG)


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_codec_arrays_with_carried_parameters(float_world, precision):
    """Encoding and query preparation with the reference's parameters:
    codes, qq and sq equal; norms, err, qn and the LUT to rtol 1e-6;
    codec_key equal."""
    ds, _, refs = float_world
    ref = refs[precision]
    port = quant_to_torch(ref, "cpu")
    if precision == "int8":
        got = P.encode_int8(port.scale, port.zero,
                            torch.from_numpy(ds.vectors), chunk=700)
    else:
        got = P.encode_pq(port.codebooks, torch.from_numpy(ds.vectors),
                          chunk=700)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref.codes))
    for g, w in zip(got[1:], (ref.norms, ref.err)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-7)
    assert P.codec_key(precision, port) == J.codec_key(precision, ref)
    rng = np.random.default_rng(4)
    q = ds.vectors[rng.integers(0, ds.n, 9)] + 0.05 * rng.normal(
        size=(9, ds.dim)).astype(np.float32)
    want = J.prepare_query(precision, ref, q)
    got = P.prepare_query(precision, port, torch.from_numpy(q))
    for name, g, w in zip(got._fields, quant_to_numpy(got), want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        if name in ("qq", "sq"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7,
                                       err_msg=name)


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_adc_and_decode_match_reference(float_world, precision):
    """quant_dist on gathered codes and the decoders, against the
    reference (rtol 1e-5: lookup and norm sums in another order)."""
    ds, _, refs = float_world
    ref = refs[precision]
    port = quant_to_torch(ref, "cpu")
    rng = np.random.default_rng(5)
    q = ds.vectors[rng.integers(0, ds.n, 6)]
    nb = rng.integers(0, ds.n, (6, 40))
    jprep = J.prepare_query(precision, ref, q)
    jcodes = ref.codes[jnp.asarray(nb)]
    if jcodes.dtype == jnp.uint8:
        jcodes = jcodes.astype(jnp.int32)
    want = J.quant_dist(precision, J.QuantGather(
        prep=jprep, codes=jcodes, norms=ref.norms[jnp.asarray(nb)]))
    pprep = P.prepare_query(precision, port, torch.from_numpy(q))
    nbt = torch.from_numpy(nb)
    got = P.quant_dist(precision, P.QuantGather(
        prep=pprep, codes=port.codes[nbt], norms=port.norms[nbt]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    dec = P.decode_int8(port) if precision == "int8" else P.decode_pq(port)
    jdec = J.decode_int8(ref) if precision == "int8" else J.decode_pq(ref)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_compressed_filtered_topk_matches_reference(float_world, precision):
    """Distances to rtol 1e-6 with atol 1e-6 — a compressed distance is a
    difference of terms near ‖q‖² + ‖x̂‖² ≈ 2, whose last bits the two
    packages round differently (XLA may contract the tail into an FMA);
    ids equal wherever the distance has no near-tie in its row."""
    from repro.index.bruteforce import valid_mask as j_valid
    from repro_torch.index.bruteforce import valid_mask

    ds, _, refs = float_world
    ref = refs[precision]
    wl = make_label_workload(ds, batch=20, kind="contain", seed=6)
    ok = j_valid(wl.spec, ds.labels_packed, ds.value_matrix)
    np.testing.assert_array_equal(
        valid_mask(pspec(wl.spec), ds.labels_packed, ds.value_matrix), ok)
    wd, wi = J.compressed_filtered_topk(precision, ref, wl.queries, ok, 10,
                                        chunk=8, n_block=512)
    gd, gi = P.compressed_filtered_topk(precision, quant_to_torch(ref, "cpu"),
                                        wl.queries, ok, 10, chunk=7,
                                        n_block=300)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=RTOL, atol=1e-6)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(np.abs(np.diff(wd, axis=1, prepend=-np.inf)),
                         np.abs(np.diff(wd, axis=1, append=np.inf)))
    apart = gap > 1e-5
    np.testing.assert_array_equal(gi[apart], wi[apart])
    assert apart.mean() > 0.9 and (wi[~fin] == -1).all()


def test_exact_rerank_matches_reference():
    """Pools with repeated ids (both buffers), invalid candidates and -1
    padding; distances exact on grid data, ids equal."""
    rng = np.random.default_rng(7)
    n, d, b, m, k = 300, 16, 9, 24, 6
    base = on_grid(rng.normal(size=(n, d)))
    q = on_grid(rng.normal(size=(b, d)))
    cand = rng.integers(0, n, (b, m)).astype(np.int32)
    cand[:, 5:] = np.where(rng.random((b, m - 5)) < 0.2, -1, cand[:, 5:])
    valid = rng.random((b, m)) < 0.7
    res = rng.integers(0, n, (b, k)).astype(np.int32)
    res[:, 1] = cand[:, 0]                        # in both buffers
    res[:, -1] = -1
    base[7] = base[8]                              # equal distances
    want = j_rerank(jnp.asarray(q), jnp.asarray(base), jnp.asarray(cand),
                    jnp.asarray(valid), jnp.asarray(res), k)
    t = torch.from_numpy
    got = exact_rerank(t(q), t(base), t(cand), t(valid), t(res), k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_quant_converters_roundtrip(float_world):
    """Reference index and prep → port → numpy: every leaf and dtype kept."""
    ds, _, refs = float_world
    for precision, ref in refs.items():
        port = quant_to_torch(ref, "cpu")
        assert type(port).__name__ == type(ref).__name__
        for g, w in zip(quant_to_numpy(port), ref):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
        prep = J.prepare_query(precision, ref, ds.vectors[:3])
        back = quant_to_numpy(qprep_to_torch(prep, "cpu"))
        for g, w in zip(back, prep):
            np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------- grid-data engines ----
@pytest.fixture(scope="module")
def world():
    ds = make_dataset(n=2000, dim=24, n_clusters=6, alphabet_size=32, seed=0)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(ds.vectors, degree=16, seed=0)
    out = {}
    for precision in ("int8", "pq"):
        jeng = JEngine.build(ds, graph, mesh=None)
        jeng.precision = precision
        jeng.quant = grid_index(precision, ds.vectors)
        eng = engine_from_arrays(ds.vectors, ds.labels_packed,
                                 ds.value_matrix, graph.neighbors,
                                 graph.entry_point, device="cpu",
                                 precision=precision, quant=jeng.quant)
        out[precision] = (jeng, eng)
    return ds, out


def _workload(ds, kind, precision, batch=12, seed=3):
    if kind == "range":
        wl = make_range_workload(ds, batch=batch, seed=seed)
    else:
        wl = make_label_workload(ds, batch=batch, kind="contain", seed=seed)
    wl.queries = grid_queries(wl.queries, precision)
    return wl


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_init_state_matches_reference(world, precision):
    ds, engines = world
    jeng, eng = engines[precision]
    wl = _workload(ds, "contain", precision)
    jcfg = JConfig(k=5, queue_size=64, precision=precision)
    jprep = J.prepare_query(precision, jeng.quant, wl.queries)
    want = j_init(jcfg, jnp.asarray(wl.queries), jeng.compile(wl.spec),
                  jeng.base_vectors, jeng._attrs(), jeng.entry_point,
                  quant=jeng.quant, qprep=jprep)
    cfg = SearchConfig(k=5, queue_size=64, precision=precision)
    got = init_state(cfg, torch.from_numpy(wl.queries),
                     eng.compile(pspec(wl.spec)), eng.base_vectors,
                     (eng.label_attrs, eng.value_attrs), eng.entry_point,
                     quant=eng.quant,
                     qprep=P.prepare_query(precision, eng.quant,
                                           torch.from_numpy(wl.queries)))
    assert_fields_equal(got, want, f"init {precision}")
    assert (np.asarray(want.q_err_sum) > 0).any()


@pytest.mark.parametrize("kind", ["contain", "range"])
@pytest.mark.parametrize("precision", ["int8", "pq"])
@pytest.mark.parametrize("pair", PAIRS)
def test_probe_resume_state_matches_reference(world, pair, precision, kind):
    """Probe to budget 100 and resume to 700: every field equal."""
    ds, engines = world
    jeng, eng = engines[precision]
    wl = _workload(ds, kind, precision)
    cfg = SearchConfig(k=5, queue_size=64, backend=pair[0])
    jcfg = JConfig(k=5, queue_size=64, backend=pair[1])
    ref = jeng.search(jcfg, wl.queries, wl.spec, 100)
    got = eng.search(cfg, wl.queries, pspec(wl.spec), 100)
    assert_fields_equal(got, ref, f"probe {pair} {precision}")
    ref = jeng.search(jcfg, wl.queries, wl.spec, 700, state=ref)
    got = eng.search(cfg, wl.queries, pspec(wl.spec), 700, state=got)
    assert_fields_equal(got, ref, f"resume {pair} {precision}")
    assert (np.asarray(ref.q_err_sum) > 0).all()


def test_precision_without_index_raises(world):
    ds, engines = world
    _, eng = engines["int8"]
    eng32 = dataclasses.replace(eng, precision="float32", quant=None)
    wl = _workload(ds, "contain", "int8")
    with pytest.raises(ValueError, match="without a quant index"):
        eng32.search(SearchConfig(k=5, queue_size=64, precision="int8"),
                     wl.queries, pspec(wl.spec), 100)
    assert eng.codec_key(SearchConfig(precision="float32")) == "float32"
    assert eng.codec_key() == J.codec_key("int8", engines["int8"][0].quant)


@pytest.fixture(scope="module")
def estimators(world):
    """The reference's estimator per codec, trained on its engine with the
    compressed target, and carried into the port."""
    ds, engines = world
    out = {}
    for precision, (jeng, _) in engines.items():
        wl = _workload(ds, "contain", precision, batch=48, seed=10)
        td = j_training(jeng, ds, wl, JConfig(k=5, queue_size=64),
                        probe_budget=32, chunk=48)
        jest = JEstimator.fit(td.features, td.w_q, n_trees=30, depth=4,
                              min_child=5)
        m = jest.model
        out[precision] = (jest, CostEstimator(gbdt_from_arrays(
            m.feat, m.thresh, m.leaf, m.base, m.depth, m.importances)), wl,
            td)
    return out


@pytest.mark.parametrize("precision", ["int8", "pq"])
def test_training_labels_match_reference(world, estimators, precision):
    """Compressed convergence target: W_q, converged and the exact ground
    truth equal; features to 1e-5."""
    ds, engines = world
    _, eng = engines[precision]
    _, _, wl, want = estimators[precision]
    pwl = QueryWorkload(wl.queries, pspec(wl.spec), wl.sigma_global,
                        wl.hardness)
    got = generate_training_data(eng, ds, pwl,
                                 SearchConfig(k=5, queue_size=64),
                                 probe_budget=32, chunk=48)
    np.testing.assert_array_equal(got.w_q, want.w_q)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.gt_dist, want.gt_dist)
    np.testing.assert_allclose(got.features, want.features, rtol=1e-5,
                               atol=1e-5)
    assert 0.2 < want.converged.mean() < 1.0


@pytest.mark.parametrize("kind", ["contain", "range"])
@pytest.mark.parametrize("precision", ["int8", "pq"])
@pytest.mark.parametrize("pair", PAIRS)
def test_e2e_rerank_matches_reference(world, estimators, pair, precision,
                                      kind):
    """probe → estimate → resume → rerank: budgets, the reranked top-k
    (ids and exact distances) and NDC equal the reference's."""
    ds, engines = world
    jeng, eng = engines[precision]
    jest, est, _, _ = estimators[precision]
    wl = _workload(ds, kind, precision, batch=13, seed=20)
    ref = j_e2e(jeng, jest, JConfig(k=5, queue_size=64, backend=pair[1]),
                wl.queries, wl.spec, probe_budget=32)
    got = e2e_search(eng, est, SearchConfig(k=5, queue_size=64,
                                            backend=pair[0]),
                     wl.queries, pspec(wl.spec), probe_budget=32)
    np.testing.assert_array_equal(got.predicted_budget,
                                  np.asarray(ref.predicted_budget))
    assert_fields_equal(got.state, ref.state, f"e2e {pair} {precision}")
    # the rerank replaced the compressed result distances with exact ones
    ri = got.state.res_idx.numpy()
    exact = ((wl.queries[:, None, :] - ds.vectors[np.maximum(ri, 0)]) ** 2
             ).sum(-1)
    fin = ri >= 0
    np.testing.assert_allclose(got.state.res_dist.numpy()[fin], exact[fin],
                               rtol=1e-6)
