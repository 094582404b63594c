"""Retrieval-augmented generation across the two packages, on the CPU.

The same filtered requests are served by the reference's and the port's
`CostAwareScheduler` on one small world (grid data, the reference's graph
and estimator carried across); their ids become context tokens as the
reference's launcher makes them (`repro/launch/serve.py:239-278`); the
olmo-1b `tiny()` LM with the reference's `init_params(key(0))`, carried
by `convert.lm_params_to_torch`, prefills them and greedy-decodes. The
port's `launch.serve._generate` is called directly (the whole launcher
runs in `test_torch_serve.py`); the reference's generation is its
`_generate` step for step. Served ids, NDC and budgets must be equal, and
so must every generated id. The port's examples are imported (not run)
and must import nothing of JAX or of the reference.
"""
import ast
import contextlib
import importlib.util
import io
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import CostEstimator as JEstimator
from repro.core import SearchConfig as JConfig
from repro.core import SearchEngine as JEngine
from repro.core import generate_training_data as j_training
from repro.data import make_dataset as j_make_dataset
from repro.data import make_label_workload as j_label
from repro.index import build_graph_index
from repro.models import build_model as j_build_model
from repro.models import split_tree
from repro.models.transformer import _pad_cache_seq as j_pad_cache_seq
from repro.serve import CostAwareScheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import requests_from_workload as j_requests
from repro_torch.configs import get_arch
from repro_torch.convert import (engine_from_arrays, estimator_to_torch,
                                 lm_params_to_torch)
from repro_torch.core import SearchConfig
from repro_torch.data import make_dataset, make_label_workload
from repro_torch.filters.predicates import PRED_CONTAIN
from repro_torch.launch import serve
from repro_torch.serve import (CostAwareScheduler, ServeConfig,
                               requests_from_workload)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = 32
GEN_LEN = 8


def on_grid(a):
    return (np.round(np.asarray(a) * 64) / 64).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """10 contain requests served by both schedulers (dense backend, lane
    width 4, escalate between two buckets) over one grid world."""
    kw = dict(n=1500, dim=16, n_clusters=6, alphabet_size=24, seed=0)
    jds, ds = j_make_dataset(**kw), make_dataset(**kw)
    jds.vectors = on_grid(jds.vectors)
    ds.vectors = on_grid(ds.vectors)
    graph = build_graph_index(jds.vectors, degree=12, seed=0)
    jeng = JEngine.build(jds, graph, backend="dense", mesh=None)
    eng = engine_from_arrays(ds.vectors, ds.labels_packed, ds.value_matrix,
                             np.asarray(graph.neighbors), graph.entry_point,
                             backend="dense", device="cpu")
    jcfg = JConfig(k=4, queue_size=48, pred_kind=PRED_CONTAIN)
    wl_tr = j_label(jds, batch=64, kind="contain", seed=7)
    wl_tr.queries = on_grid(wl_tr.queries)
    td = j_training(jeng, jds, wl_tr, jcfg, probe_budget=PROBE, chunk=64)
    jest = JEstimator.fit(td.features, td.w_q, n_trees=30, depth=3)
    jwl = j_label(jds, batch=10, kind="contain", seed=42)
    wl = make_label_workload(ds, batch=10, kind="contain", seed=42)
    jwl.queries = on_grid(jwl.queries)
    wl.queries = on_grid(wl.queries)
    np.testing.assert_array_equal(wl.queries, jwl.queries)
    scfg = dict(lane_width=4, buckets=(128, None), policy="escalate",
                probe_budget=PROBE, alpha=1.5)
    jsched = JScheduler(jeng, jest, jcfg, JServeConfig(**scfg))
    sched = CostAwareScheduler(eng, estimator_to_torch(jest),
                               SearchConfig(k=4, queue_size=48,
                                            pred_kind=PRED_CONTAIN),
                               ServeConfig(**scfg))
    jreqs, reqs = j_requests(jwl), requests_from_workload(wl)
    for sch, rs in ((jsched, jreqs), (sched, reqs)):
        for r in rs:
            assert sch.submit(r, 0.0) == "queued"
        sch.run_until_idle(0.0)
    return jreqs, reqs


def ref_generate(reqs, gen_len):
    """The reference launcher's `_generate`, keeping every generated id."""
    mcfg = j_get_arch("olmo-1b").tiny()
    model = j_build_model(mcfg)
    prm, _ = split_tree(model.init_params(jax.random.key(0)))
    done = [r for r in reqs if r.res_idx is not None]
    b = len(done)
    doc_ids = np.stack([np.abs(r.res_idx) % mcfg.vocab_size for r in done])
    prompts = np.random.default_rng(0).integers(0, mcfg.vocab_size, (b, 8))
    tokens = jnp.asarray(np.concatenate([doc_ids, prompts], axis=1),
                         jnp.int32)
    logits, part = jax.jit(model.prefill)(prm, {"tokens": tokens})
    cache, _ = split_tree(model.init_cache(b, tokens.shape[1] + gen_len))
    cache = j_pad_cache_seq(cache, part)
    decode = jax.jit(model.decode_step)
    cur = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
    out = [np.asarray(cur)]
    pos = jnp.full((b,), tokens.shape[1], jnp.int32)
    for t in range(gen_len - 1):
        logits, cache = decode(prm, cache, cur, pos + t, None)
        cur = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
        out.append(np.asarray(cur))
    return np.concatenate(out, axis=1), prm


def test_rag_generation_matches_reference(served):
    """Served ids → context tokens → prefill + 7 decode steps: the same
    retrieval and the same generated ids as the reference."""
    jreqs, reqs = served
    assert [r.rid for r in reqs] == [r.rid for r in jreqs]
    for j, p in zip(jreqs, reqs):
        np.testing.assert_array_equal(p.res_idx, np.asarray(j.res_idx))
        assert (p.ndc, p.budget) == (j.ndc, j.budget)
    assert any(r.n_slices >= 2 for r in reqs)     # escalate requeued some
    want, prm = ref_generate(jreqs, GEN_LEN)
    model = lm_params_to_torch(get_arch("olmo-1b").tiny(),
                               jax.tree.map(np.asarray, prm), device="cpu")
    args = types.SimpleNamespace(gen_len=GEN_LEN, arch="olmo-1b",
                                 device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = serve._generate(args, reqs, model=model)
    assert got.shape == (len(reqs), GEN_LEN)
    np.testing.assert_array_equal(got, want)
    assert out.getvalue().startswith("generation: ")


def test_generate_builds_its_own_model(served):
    """Without a model `_generate` builds `get_arch(--arch).tiny()` on
    `--device` from seed 0: valid ids, and the same ids twice."""
    _, reqs = served
    args = types.SimpleNamespace(gen_len=3, arch="granite-3-2b", device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        a = serve._generate(args, reqs)
        b = serve._generate(args, reqs)
        none = serve._generate(args, [])
    vocab = get_arch("granite-3-2b").vocab_size
    assert a.shape == (len(reqs), 3) and ((a >= 0) & (a < vocab)).all()
    np.testing.assert_array_equal(a, b)
    assert none is None


EXAMPLES = ["serve_rag_torch.py", "quickstart_torch.py",
            "adaptive_termination_demo_torch.py", "train_tiny_lm_torch.py"]
PORT_TREES = ["src/repro_torch/configs", "src/repro_torch/models",
              "src/repro_torch/train", "src/repro_torch/launch",
              "src/repro_torch/convert.py"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _foreign(path):
    return [m for m in _imports(path)
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_the_port_only(name):
    path = os.path.join(ROOT, "examples", name)
    assert _foreign(path) == []
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)


def test_lm_modules_import_neither_jax_nor_the_reference():
    files = []
    for p in PORT_TREES:
        full = os.path.join(ROOT, p)
        files += ([full] if full.endswith(".py") else
                  [os.path.join(full, f) for f in os.listdir(full)
                   if f.endswith(".py")])
    assert len(files) >= 10
    assert {f: _foreign(f) for f in files if _foreign(f)} == {}
