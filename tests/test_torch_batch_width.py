"""A lane's entry distance and rerank distances do not depend on how many
lanes share the batch — the property scheduled ≡ one-shot and the sharded
engine rest on.

On the card a torch reduction's rounding depends on the batch shape, so
`init_state` takes the float32 entry distance from K6 (an all-true mask
over the entry row), the ADC entry distance from K6q rows, and the rerank
scores its pool with K6; the codecs' query norms are tree sums and the
PQ lookup table an ordered elementwise sum. Each gives
a (query, row) pair the same bits in any batch. These tests hold, for
lanes 0..7, `d_start` and the rerank's distances in batches of 1, 4, 8,
16 and 64 to the 64-lane batch's, bit for bit, at float32, int8 and PQ,
on unrounded data; and the entry distance to K1's (K3's, K4's) for the
entry row inside a traversal step. The `cuda` cases run the kernels and
skip without a card; the CPU cases hold the plain versions to the same.

Tolerance: none (bit for bit).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import SearchConfig, SearchEngine, take_lanes
from repro_torch.data import make_dataset, make_label_workload
from repro_torch.index import build_graph_index
from repro_torch.kernels.fused_step import fused_step
from repro_torch.kernels.topk import unpack_payload
from repro_torch.quant.codecs import QuantGather, prepare_query
from repro_torch.quant.rerank import exact_rerank

DEVICES = [pytest.param("cpu"),
           pytest.param("cuda", marks=pytest.mark.cuda)]
PRECISIONS = ["float32", "int8", "pq"]
WIDTHS = (1, 4, 8, 16, 64)
CFG = SearchConfig(k=10, queue_size=64, backend="fused")


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6, K6q rows and K1 have no CPU "
                    "mode)")


@functools.lru_cache(maxsize=None)
def _world(device: str, precision: str):
    """N=2000, d=64 unrounded vectors, a degree-16 graph and an engine at
    `precision`, with a 64-lane contain workload."""
    ds = make_dataset(n=2000, dim=64, n_clusters=8, alphabet_size=16,
                      seed=3)
    graph = build_graph_index(ds.vectors, degree=16, seed=0, device=device)
    qcfg = (None if precision == "float32" else
            {"pq_subspaces": 16, "pq_centroids": 32, "pq_iters": 4,
             "train_sample_size": 1024})
    eng = SearchEngine.build(ds, graph, device=device, precision=precision,
                             quant_cfg=qcfg, backend="fused")
    wl = make_label_workload(ds, batch=64, kind="contain", seed=5)
    return ds, eng, wl


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_entry_distance_is_batch_width_invariant(device, precision):
    _need(device)
    ds, eng, wl = _world(device, precision)
    full = eng.search(CFG, wl.queries, wl.spec, 1)   # init only: cnt = 1
    want = _bits(full.d_start)
    for b in WIDTHS:
        st = eng.search(CFG, wl.queries[:b], wl.spec.slice(slice(0, b)), 1)
        n = min(b, 8)
        np.testing.assert_array_equal(_bits(st.d_start)[:n], want[:n],
                                      err_msg=f"B={b}")
    if precision != "float32":
        q = torch.from_numpy(wl.queries).to(device)
        p64 = prepare_query(precision, eng.quant, q)
        for b in WIDTHS:
            pb = prepare_query(precision, eng.quant, q[:b])
            np.testing.assert_array_equal(_bits(pb.qn), _bits(p64.qn)[:b])


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_rerank_distances_are_batch_width_invariant(device, precision):
    """The exact float32 rerank of a finished traversal's pool, lanes 0..7
    scored in batches of every width against the 64-lane batch."""
    _need(device)
    ds, eng, wl = _world(device, precision)
    st = eng.search(CFG, wl.queries, wl.spec, 400)
    q = torch.from_numpy(wl.queries).to(device)
    base = torch.from_numpy(ds.vectors).to(device)
    rd, ri = exact_rerank(q, base, st.cand_idx, st.cand_valid, st.res_idx, 10)
    assert bool(torch.isfinite(rd[:8, 0]).all())
    for b in WIDTHS:
        sub = take_lanes(st, list(range(b)))
        gd, gi = exact_rerank(q[:b], base, sub.cand_idx, sub.cand_valid,
                              sub.res_idx, 10)
        n = min(b, 8)
        np.testing.assert_array_equal(_bits(gd)[:n], _bits(rd)[:n],
                                      err_msg=f"B={b}")
        assert torch.equal(gi[:n], ri[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_entry_distance_is_k1s_on_cuda(precision):
    """`d_start` == the distance K1 (K3, K4) stores for the entry row when
    it sits in a step's frontier (position 5 of 16, from an empty queue),
    bit for bit."""
    _need("cuda")
    ds, eng, wl = _world("cuda", precision)
    b, r, m, k = 64, 16, 64, 10
    st = eng.search(CFG, wl.queries, wl.spec, 1)
    q = torch.from_numpy(wl.queries).cuda()
    ep = eng.entry_point
    nb = torch.arange(r, dtype=torch.int32, device="cuda")
    nb = torch.where(nb == ep, r, nb)          # the entry appears once
    nb[5] = ep
    nb = nb.repeat(b, 1).contiguous()
    rows = nb.long()
    prog = eng.compile(wl.spec)
    quant = None
    x = eng.base_vectors[rows].contiguous()
    if precision != "float32":
        x = None
        quant = QuantGather(prep=prepare_query(precision, eng.quant, q),
                            codes=eng.quant.codes[rows].contiguous(),
                            norms=eng.quant.norms[rows].contiguous())
    f32, i32 = torch.float32, torch.int32
    out = fused_step(
        q, x, nb, torch.ones((b, r), dtype=torch.bool, device="cuda"), prog,
        eng.label_attrs[rows].contiguous(), eng.value_attrs[rows].contiguous(),
        torch.full((b, m), float("inf"), dtype=f32, device="cuda"),
        torch.full((b, m), -1, dtype=i32, device="cuda"),
        torch.full((b, k), float("inf"), dtype=f32, device="cuda"),
        torch.full((b, k), -1, dtype=i32, device="cuda"),
        quant=quant, precision=precision)
    cd, cp = out[0], out[1]
    ids = unpack_payload(cp)[0]
    at = (ids == ep).to(torch.int8).argmax(dim=1, keepdim=True)
    assert bool((ids == ep).any(dim=1).all())
    np.testing.assert_array_equal(_bits(torch.gather(cd, 1, at)[:, 0]),
                                  _bits(st.d_start))
