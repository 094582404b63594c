"""Parity of the port's training path (`repro_torch.train`,
`DecoderLM.loss`) with the reference's (`repro.train`,
`repro.models.transformer`), on the CPU.

Inputs are drawn from seeded numpy generators and go through both
packages; model parameters are the reference's `init_params(key(0))`
carried across by `convert.lm_params_to_torch`, train states by
`convert.lm_train_state_to_torch` and compared leaf by leaf through
`convert.lm_train_state_to_numpy`. Covered: `quantize` / `dequantize`,
`adamw_update` (float32 / bfloat16 / int8 moments, clip on and off),
the quadratic and error-feedback toy problems of `tests/test_distributed.py`,
`_xent` / `_xent_chunked`, `DecoderLM.loss` and its gradients on four
tiny dense configs, three `make_train_step` steps, remat on ≡ off,
checkpoints (rotation, integrity, shapes, both packages' files), resume
≡ uninterrupted, the launcher and the example's batches.

Tolerances (XLA:CPU and torch sum in different orders, and the port
sums the clip norm over per-layer leaves where the reference sums
stacked ones; the largest differences measured are in brackets):
  - `quantize` / `dequantize`: bit for bit (XLA compiles the division
    by 127 into a product by 1/127; the port computes that product);
  - losses: atol 1e-5 + rtol 1e-5 (1.4e-6);
  - gradients: |Δ| ≤ GRAD_TOL · max |g| of the leaf (2.4e-6);
  - `adamw_update` on identical gradients: parameters within atol 1e-6 +
    rtol 1e-4, moments within STATE_TOL · max |leaf|;
  - train steps: moments and float32 leaves within STATE_TOL · max
    |leaf| (3.6e-6), bfloat16 also one bf16 ulp; an int8 moment
    dequantized within STATE_TOL · max plus `quanta` quanta of its block
    (3 after 3 steps: a level flips where the inputs differ by ulps;
    measured 2); parameters within PARAM_STEP_TOL · lr · steps (0.003):
    AdamW normalises each element, so where |g| nears eps its step
    follows g's ulps; under int8 moments all within lr · steps (0.076)
    and all but INT8_PARAM_SHARE within PARAM_STEP_TOL · lr · steps (2 of
    164,416); ef_error: all but EF_FLIP_SHARE of each leaf within EF_TOL
    · max |e| (0.0039: where a level of the gradient's code flipped);
  - remat on ≡ off, resume ≡ uninterrupted: bit for bit.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.models import split_tree
from repro.models.common import P
from repro.models.transformer import _xent as j_xent
from repro.models.transformer import _xent_chunked as j_xent_chunked
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_leaves_to_numpy, lm_params_to_torch,
                                 lm_train_state_to_numpy,
                                 lm_train_state_to_torch)
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.transformer import _xent, _xent_chunked
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainConfig,
                               adamw_update, dequantize, generate,
                               init_opt_state, load_state_, loss_and_grads,
                               make_init_state, make_train_step, quantize)
from repro_torch.train import optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
P_ATOL, P_RTOL = 1e-6, 1e-4
STATE_TOL = 1e-5
PARAM_STEP_TOL = 2e-2
INT8_PARAM_SHARE = 1e-3
EF_TOL, EF_FLIP_SHARE = 1e-2, 1e-2
BF16_RTOL = 8e-3
DENSE = ["olmo-1b", "granite-3-2b", "h2o-danube-3-4b", "gemma3-12b"]
SEQ = 40   # longer than the tiny configs' window of 32

J_QUANTIZE = jax.jit(j_opt.quantize)
J_DEQUANTIZE = jax.jit(j_opt.dequantize, static_argnums=1)


def _cfgs(name):
    return get_arch(name).tiny(), j_get_arch(name).tiny()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _ref_values(jm):
    return jax.tree.map(np.asarray, split_tree(
        jm.init_params(jax.random.key(0)))[0])


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_moments_close(got, want, what, quanta=1):
    """Each float leaf within STATE_TOL · max |leaf| of the reference's
    (bfloat16: also one bf16 ulp); an int8 moment ({"q", "scale"})
    dequantized, also within `quanta` quanta (its block's larger scale):
    a level may flip where the two packages' inputs differ by ulps."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), what
    for k in w:
        if k.endswith("/scale"):
            continue
        wk = w[k].astype(np.float32)
        atol = STATE_TOL * np.abs(wk).max()
        gk = g[k]
        if k.endswith("/q"):
            gs, ws = g[k[:-1] + "scale"], w[k[:-1] + "scale"]
            gk = (gk.reshape(*gs.shape, -1) * gs[..., None]).ravel()
            wk = (wk.reshape(*ws.shape, -1) * ws[..., None]).ravel()
            atol = (STATE_TOL * np.abs(wk).max()
                    + quanta * np.repeat(np.maximum(gs, ws).ravel(),
                                         g[k].shape[-1] // gs.shape[-1]))
        rtol = BF16_RTOL if w[k].dtype == np.dtype(jnp.bfloat16) else 0.0
        assert (np.abs(gk - wk) <= atol + rtol * np.abs(wk)).all(), (what, k)


def _assert_ef_close(got, want):
    """ef_error (x − dequantize(quantize(x))): all but EF_FLIP_SHARE of
    each leaf's elements within EF_TOL · max |e|; the rest are where a
    level of x's int8 code flipped, which moves e by one quantum."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        d = np.abs(g[k] - w[k])
        far = (d > EF_TOL * np.abs(w[k]).max()).mean()
        assert far <= EF_FLIP_SHARE, (k, far)


def _assert_params_close(got, want, lr, steps, int8):
    """Parameters after `steps` Adam steps: within PARAM_STEP_TOL · lr ·
    steps (Adam normalises each element, so where |g| is near eps its
    step follows the ulps of g); under int8 moments, where one level of a
    moment flips, all within lr · steps and all but INT8_PARAM_SHARE of
    the elements within PARAM_STEP_TOL · lr · steps."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    far = n = 0
    for k in w:
        d = np.abs(g[k] - w[k])
        n += d.size
        far += int((d > PARAM_STEP_TOL * lr * steps).sum())
        assert d.max() <= (1.0 if int8 else PARAM_STEP_TOL) * lr * steps, \
            (k, d.max() / (lr * steps))
    assert far <= (INT8_PARAM_SHARE * n if int8 else 0), (far, n)


# ------------------------------------------------------ int8 quantizer ----
QUANT_CASES = {
    "33x300x5": lambda rng: rng.normal(size=(33, 300)).astype(np.float32)
    * 5.0,
    "3d": lambda rng: rng.normal(size=(2, 5, 130)).astype(np.float32),
    "ties": lambda rng: np.tile(np.concatenate(
        [np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0],
                  np.float32), np.zeros(120, np.float32)]), (3, 1)),
    "zeros": lambda rng: np.zeros((4, 256), np.float32),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_matches_reference_bitwise(case):
    """q, scale and the dequantized values bit for bit the reference's,
    within the round trip's bound (`test_quantize_roundtrip`)."""
    x = QUANT_CASES[case](np.random.default_rng(0))
    want = J_QUANTIZE(jnp.asarray(x))
    got = quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want.scale))
    back = dequantize(got, x.shape).numpy()
    np.testing.assert_array_equal(back, np.asarray(
        J_DEQUANTIZE(want, x.shape)))
    assert np.abs(back - x).max() <= np.abs(x).max() / 127 + 1e-6


# ------------------------------------------------------------ AdamW ----
OPT_SHAPES = {"a": (4, 200), "b": (3, 2, 128), "c": (7,)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(moment_dtype, clip):
    """5 steps on three leaves (a padded last dim, a 3-D leaf, a vector)
    with seeded gradients large enough for the clip to act."""
    rng = np.random.default_rng(3)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in OPT_SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 0.3).astype(np.float32)
              for k, s in OPT_SHAPES.items()} for _ in range(5)]
    kw = dict(lr=1e-2, weight_decay=0.1, moment_dtype=moment_dtype,
              grad_clip=clip)
    jcfg, cfg = j_opt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = {k: P(jnp.asarray(v), (None,) * v.ndim) for k, v in p0.items()}
    jopt = split_tree(j_opt.init_opt_state(jp, jcfg))[0]
    jvals = {k: jnp.asarray(v) for k, v in p0.items()}
    update = jax.jit(lambda p, g, o: j_opt.adamw_update(p, g, o, jcfg))
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = init_opt_state(params, cfg)
    for g in grads:
        jvals, jopt = update(jvals, {k: jnp.asarray(v) for k, v in g.items()},
                             jopt)
        adamw_update(params, {k: torch.from_numpy(v) for k, v in g.items()},
                     opt, cfg)
    assert int(opt["count"]) == int(jopt["count"]) == 5
    for k in p0:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jvals[k]),
                                   atol=P_ATOL, rtol=P_RTOL, err_msg=k)
    for which in ("m", "v"):
        got = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                   else v.to(torch.float32).numpy())
               for k, v in opt[which].items()}
        _assert_moments_close(got, jax.tree.map(np.asarray, jopt[which]),
                              which)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_row_slices_change_no_bit(moment_dtype, monkeypatch):
    """A leaf of more than `optimizer.CHUNK` elements is updated in slices
    of whole rows: 3 clipped steps with CHUNK cut to 700 elements (slices
    of 3 rows of the [4, 200] leaf, the last one short; of 2 rows of the
    [3, 2, 128] leaf, the last one short; the vector whole) leave every
    parameter and moment bit for bit as the whole-leaf update does."""
    rng = np.random.default_rng(4)
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in OPT_SHAPES.items()}
    grads = [{k: torch.from_numpy((rng.normal(size=s) * 0.3).astype(
        np.float32)) for k, s in OPT_SHAPES.items()} for _ in range(3)]
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    runs = []
    for chunk in (optimizer.CHUNK, 700):
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        opt = init_opt_state(params, cfg)
        for g in grads:
            adamw_update(params, g, opt, cfg)
        runs.append({"p": params, "m": opt["m"], "v": opt["v"]})
    assert len(optimizer._row_slices(runs[0]["p"]["a"])) > 1
    whole, sliced = (_leaves(jax.tree.map(lambda t: t.float().numpy(), r))
                     for r in runs)
    assert whole.keys() == sliced.keys()
    for k in whole:
        np.testing.assert_array_equal(sliced[k], whole[k], err_msg=k)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_converges_quadratic(moment_dtype):
    """Minimize ||p − target||² — int8 moments must still converge
    (`tests/test_distributed.py::test_adamw_converges_quadratic`)."""
    target = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 256)).astype(np.float32))
    w = torch.zeros((4, 256), requires_grad=True)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype=moment_dtype)
    opt = init_opt_state({"w": w}, cfg)
    for _ in range(200):
        (g,) = torch.autograd.grad(torch.mean((w - target) ** 2), [w])
        adamw_update({"w": w}, {"w": g}, opt, cfg)
    loss = float(torch.mean((w - target) ** 2))
    assert loss < 1e-2, loss


class _ToyModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((8, 32)))

    def loss(self, batch):
        pred = batch["x"] @ self.w
        return (torch.mean((pred - batch["y"]) ** 2),
                {"ce": torch.zeros(())})


class _JToyModel:
    def init_params(self, key):
        return {"w": P(jnp.zeros((8, 32)), (None, None))}

    def loss(self, prm, batch):
        pred = batch["x"] @ prm["w"]
        return jnp.mean((pred - batch["y"]) ** 2), {"ce": jnp.float32(0)}


def test_grad_compression_error_feedback():
    """int8 EF: one step's ef_error and parameters match the reference's
    toy model; then compressed-grad training converges
    (`tests/test_distributed.py::test_grad_compression_error_feedback`)."""
    rng = np.random.default_rng(2)
    w_true = rng.normal(size=(8, 32)).astype(np.float32)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = x @ w_true
    kw = dict(lr=0.02, weight_decay=0.0)
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(**kw),
                           grad_compression="int8_ef")
    jstate = split_tree(j_ts.make_init_state(_JToyModel(), jtc)(
        jax.random.key(0)))[0]
    jstate, _ = jax.jit(j_ts.make_train_step(_JToyModel(), jtc))(
        jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    model = _ToyModel()
    tc = TrainConfig(opt=AdamWConfig(**kw), grad_compression="int8_ef")
    state, step = make_init_state(model, tc), make_train_step(model, tc)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    state, _ = step(state, batch)
    np.testing.assert_allclose(state["ef_error"]["w"].numpy(),
                               np.asarray(jstate["ef_error"]["w"]),
                               atol=1e-6, rtol=P_RTOL)
    np.testing.assert_allclose(model.w.detach().numpy(),
                               np.asarray(jstate["params"]["w"]),
                               atol=P_ATOL, rtol=P_RTOL)
    for _ in range(299):
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < 0.05, float(metrics["loss"])


# --------------------------------------------------------- cross-entropy ----
def test_xent_chunked_matches_reference():
    """Chunks of 16 over s = 40 (the last chunk padded and masked): the
    value and the gradients with respect to h and the head; `_xent`."""
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 40, 8)).astype(np.float32)
    w = rng.normal(size=(8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.float32)
    mask[:, -1] = 0.0

    def j_fn(hh, ww):
        return j_xent_chunked(lambda x: x @ ww, hh, jnp.asarray(labels),
                              jnp.asarray(mask), chunk=16)

    want, (wgh, wgw) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = _xent_chunked(lambda x: x @ tw, th, torch.from_numpy(labels),
                        torch.from_numpy(mask), chunk=16)
    gh, gw = torch.autograd.grad(got, [th, tw])
    np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wgh), atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(wgw), atol=1e-6)
    logits = h @ w
    np.testing.assert_allclose(
        float(_xent(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(j_xent(jnp.asarray(logits), jnp.asarray(labels))),
        atol=LOSS_TOL, rtol=LOSS_TOL)


# ------------------------------------------------------------ the loss ----
@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grads_match_reference(name):
    """`DecoderLM.loss` and every gradient leaf against
    `jax.value_and_grad(model.loss)` on the reference's init_params."""
    cfg, jcfg = _cfgs(name)
    jm = j_build_model(jcfg)
    values = _ref_values(jm)
    tokens = _tokens(cfg, 2, SEQ, 5)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, values), {"tokens": jnp.asarray(tokens)})
    model = lm_params_to_torch(cfg, values, device="cpu")
    params = dict(model.named_parameters())
    loss, met, grads = loss_and_grads(model, params,
                                      {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    got, want = _leaves(lm_leaves_to_numpy(model, grads)), _leaves(jgrads)
    assert set(got) == set(want)
    assert (sum(a.size for a in got.values())
            == sum(p.numel() for p in params.values()))
    for k in want:
        tol = GRAD_TOL * np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=k)


TRAIN_CASES = [("olmo-1b", 1, "none", "float32"),
               ("granite-3-2b", 2, "int8_ef", "int8")]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def test_train_steps_match_reference(case):
    """3 `make_train_step` steps from the reference's initial state: each
    step's loss and ce, then every leaf of the state (parameters,
    moments, count, step, ef_error)."""
    name, accum, comp, moments = case
    cfg, jcfg = _cfgs(name)
    kw = dict(lr=1e-3, moment_dtype=moments)
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(**kw), grad_accum=accum,
                           grad_compression=comp)
    tc = TrainConfig(opt=AdamWConfig(**kw), grad_accum=accum,
                     grad_compression=comp)
    jm = j_build_model(jcfg)
    jstate = split_tree(j_ts.make_init_state(jm, jtc)(jax.random.key(0)))[0]
    values = jax.tree.map(np.asarray, jstate)
    model, state = lm_train_state_to_torch(cfg, tc, values, device="cpu")
    back = _leaves(lm_train_state_to_numpy(model, state))
    want0 = _leaves(values)
    assert set(back) == set(want0)
    for k in want0:      # the converters are exact inverses
        np.testing.assert_array_equal(back[k], want0[k], err_msg=k)
    jstep = jax.jit(j_ts.make_train_step(jm, jtc))
    step = make_train_step(model, tc)
    for i in range(3):
        tokens = _tokens(cfg, 4, SEQ, 10 + i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, met = step(state, {"tokens": torch.from_numpy(tokens)})
        for key in ("loss", "ce"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL)
    got = lm_train_state_to_numpy(model, state)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"]) == 3
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 3
    _assert_params_close(got["params"], want["params"], kw["lr"], 3,
                         moments == "int8")
    for which in ("m", "v"):
        _assert_moments_close(got["opt"][which], want["opt"][which], which,
                              quanta=3)
    if comp == "int8_ef":
        _assert_ef_close(got["ef_error"], want["ef_error"])


def test_remat_on_equals_off_bitwise():
    """Checkpointing each group changes no bit of the loss or of any
    gradient (gemma3 tiny: groups of two layers, one windowed)."""
    cfg = get_arch("gemma3-12b").tiny()
    assert cfg.remat
    tokens = {"tokens": torch.from_numpy(_tokens(cfg, 2, SEQ, 6))}
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        m = build_model(c, device="cpu",
                        generator=torch.Generator().manual_seed(1))
        out.append(loss_and_grads(m, dict(m.named_parameters()), tokens))
    (l1, _, g1), (l2, _, g2) = out
    assert torch.equal(l1, l2)
    assert g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_serving_builds_no_autograd_graph():
    """Trainable parameters, yet prefill, decode and generate hold no
    graph."""
    cfg = get_arch("olmo-1b").tiny()
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in m.parameters())
    tokens = torch.from_numpy(_tokens(cfg, 2, 8, 0))
    logits, cache = m.prefill(tokens)
    assert logits.grad_fn is None and cache[0]["k"].grad_fn is None
    run = generate(m, tokens, 3)
    assert run["logits"].grad_fn is None and not run["logits"].requires_grad


# ---------------------------------------------------------- checkpoints ----
def _sample_state():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(
        3, 4), "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)},
        "opt": {"q": torch.tensor([[-127, 3]], dtype=torch.int8),
                "count": torch.tensor(7, dtype=torch.int32)},
        "step": torch.tensor(7, dtype=torch.int32)}


def _add(tree, d):
    if isinstance(tree, dict):
        return {k: _add(v, d) for k, v in tree.items()}
    return tree + d


def test_checkpoint_rotation_and_restore(tmp_path):
    """keep=2 keeps the newest two; restore gives every leaf back in its
    dtype; the tmp directory never stays behind."""
    state = _sample_state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for i, s in enumerate((7, 8, 9)):
        mgr.save(s, _add(state, i))
    assert mgr.all_steps() == [8, 9] and mgr.latest_step() == 9
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    restored, manifest = mgr.restore_latest(state)
    assert manifest["step"] == 9
    want = _add(state, 2)
    for path in (("params", "w"), ("params", "b"), ("opt", "q"),
                 ("opt", "count")):
        got, exp = restored[path[0]][path[1]], want[path[0]][path[1]]
        assert got.dtype == exp.dtype and torch.equal(got, exp), path
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        state) == (None, None)


def test_checkpoint_integrity_and_shape_checks(tmp_path):
    """A flipped byte raises IOError; a leaf of another shape ValueError."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.ones(4)}
    path = mgr.save(1, state)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"w": torch.ones(5)})
    with open(f"{path}/arrays.npz", "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.raises(IOError):
        mgr.restore(1, state)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A plain nested dict saved by either package restores in the
    other, with the same manifest keys, shapes and dtypes."""
    rng = np.random.default_rng(9)
    plain = {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                        "emb/x": rng.normal(size=(5,)).astype(np.float32)},
             "opt": {"q": rng.integers(-127, 128, (2, 128)).astype(np.int8),
                     "count": np.int32(4)},
             "step": np.int32(4)}
    jtree = jax.tree.map(jnp.asarray, plain)
    ttree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), plain)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.CheckpointManager(jdir).save(4, jtree)
    CheckpointManager(tdir).save(4, ttree)
    if writer == "reference":
        got, man = CheckpointManager(jdir).restore(4, ttree)
        got = jax.tree.map(lambda t: t.numpy(), got)
    else:
        abstract = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jtree)
        got, man = j_ckpt.CheckpointManager(tdir).restore(4, abstract)
        got = jax.tree.map(np.asarray, got)
    other = (CheckpointManager(tdir) if writer == "reference"
             else CheckpointManager(jdir))
    _, man2 = other.restore(4, ttree)
    for key in ("keys", "shapes", "dtypes", "step"):
        assert man[key] == man2[key], key
    g, w = _leaves(got), _leaves(plain)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_checkpoint_bfloat16_leaves_cross_packages(tmp_path):
    """bfloat16 leaves: the reference's (numpy void bits) restore in the
    port, and the port's (stored as float32) in the reference, exactly."""
    vals = [1.5, -2.25, 3.0e-3]
    j_ckpt.CheckpointManager(str(tmp_path / "j")).save(
        1, {"h": jnp.asarray(vals, jnp.bfloat16)})
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(
        1, {"h": torch.zeros(3, dtype=torch.bfloat16)})
    want = torch.tensor(vals, dtype=torch.bfloat16)
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], want)
    CheckpointManager(str(tmp_path / "t")).save(1, {"h": want})
    back, _ = j_ckpt.CheckpointManager(str(tmp_path / "t")).restore(
        1, {"h": jax.ShapeDtypeStruct((3,), jnp.bfloat16)})
    assert back["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["h"], np.float32),
                                  want.float().numpy())


def test_resume_equals_uninterrupted_bitwise(tmp_path):
    """2 steps, save, restore into a fresh model's state (another seed),
    2 more steps ≡ 4 uninterrupted steps, bit for bit; the restored state
    equals the saved one bit for bit (int8 moments, int8_ef, grad_accum
    2: every kind of leaf)."""
    cfg = get_arch("olmo-1b").tiny()
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, moment_dtype="int8"),
                     grad_accum=2, grad_compression="int8_ef")
    batches = [{"tokens": torch.from_numpy(_tokens(cfg, 4, 32, 20 + i))}
               for i in range(4)]

    def fresh(seed):
        m = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
        return m, make_init_state(m, tc), make_train_step(m, tc)

    m, full, step = fresh(0)
    for b in batches:
        full, _ = step(full, b)
    m, state, step = fresh(0)
    for b in batches[:2]:
        state, _ = step(state, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    saved = lm_train_state_to_numpy(m, state)
    m2, state2, step2 = fresh(1)
    restored, manifest = mgr.restore_latest(state2)
    load_state_(state2, restored)
    assert manifest["step"] == 2 and int(state2["step"]) == 2
    for k, (a, b) in _pairs(saved, lm_train_state_to_numpy(m2, state2)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for b in batches[2:]:
        state2, _ = step2(state2, b)
    for k, (a, b) in _pairs(lm_train_state_to_numpy(m, full),
                            lm_train_state_to_numpy(m2, state2)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def _pairs(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    return [(k, (la[k], lb[k])) for k in la]


# ------------------------------------------------ launcher and example ----
def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    """`launch/train.py` on the CPU: 4 steps with a checkpoint every 2,
    then --resume to 6, which starts at step 4."""
    base = ["--device", "cpu", "--batch", "4", "--seq", "32",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    launch_train.main(base + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed" not in out and out.count("checkpoint -> ") == 2
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    launch_train.main(base + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.rstrip().endswith("done")
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]


def test_entry_points_need_a_card():
    """Without device="cpu" the launcher and build_model raise where no
    CUDA device is visible; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_arch("olmo-1b").tiny())


def _load_example(name):
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_batches_match_reference():
    """The port example's Markov-chain batches are the reference
    example's, draw for draw."""
    port = _load_example("train_tiny_lm_torch.py").synthetic_batches(
        256, batch=4, seq=16)
    ref = _load_example("train_tiny_lm.py").synthetic_batches(
        256, batch=4, seq=16)
    for _ in range(2):
        np.testing.assert_array_equal(next(port),
                                      np.asarray(next(ref)["tokens"]))
