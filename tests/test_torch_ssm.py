"""Parity of the port's Mamba2 mixer (`models/mamba2.py`) and of the SSM
(mamba2-2.7b) and hybrid (zamba2-2.7b) decoder LMs with the reference's,
on the CPU.

Inputs are drawn from seeded numpy generators and go through both
packages. Layer level: `_causal_conv` and `_ssd_chunked` at S = 48 in
three chunks of 16 (y and the final state); `mamba2_forward` with its
state, then 3 `mamba2_decode` steps (out, h and conv). The two stated
departures of `_ssd_chunked`: (a) at seq 128 in one chunk of 128 the
reference's gradients of a_log, dt_bias and wdt are NaN and the port's
finite, equal to the reference's at chunk 16 on the same input; (b) the
reference asserts on an 18-token prompt at the tiny configs' chunk of 16,
and the port equals the reference run at `ssm_chunk=18` (one chunk). Model
level, on `mamba2-2.7b.tiny()` (4 SSM layers: d 64, d_inner 128, 8 heads
of 16, N 16, conv 4, chunk 16) and `zamba2-2.7b.tiny()` (2 groups of 2
SSM layers and the shared attention + MLP block), on the reference's
`init_params(key(0))` with its zero-initialised SSM leaves (the
convolutions, a_log, dt_bias, d_skip, the gated norm) redrawn from a
seeded numpy generator — at init the convolutions are zero, so every
mixer would output zero —, carried by `convert.lm_params_to_torch`: a
[3, 18] prefill and 6 decode steps (logits, every cache leaf, greedy
ids), the port's decode ≡ a teacher-forced prefill; the reference's conv
tail after a prompt shorter than k − 1 (kept, as the reference has it);
`decode_step`'s capacity; `loss` and every gradient against `jax.grad` (zamba2's shared
block summed over its two uses, the never-read leaves of its shared_attn
positions exactly zero in both packages); 2 `make_train_step` steps
(int8 moments on mamba2, float32 on zamba2); the converters' round trip
of a zamba2 train state; `build_model`'s tree, serving and training;
the serve launcher's `_generate --arch zamba2-2.7b`; the train launcher
and the example with `--arch`.

Tolerances (XLA:CPU and torch sum in different orders; the largest
differences measured are in brackets):
  - layer outputs, states and caches within LAYER_TOL = 1e-5 · max |.|
    (conv and SSD 1.6e-7, forward and decode 8.9e-7);
  - departure (a), the port at chunk 128 against the reference at chunk
    16: the sum within rtol 1e-5, each gradient within CHUNK_GRAD_TOL =
    1e-4 · max |g| of its leaf (a_log 1.2e-5): over a chunk of 128 the
    cumulative log decay runs to ≈ −400, where a float32 ulp is 3e-5, and
    each exponent a_cs[q] − a_cs[k] carries that absolute error (the port
    in float64 agrees with itself across the two chunks within 4e-14; in
    float32 at chunk 128 it is 1.3e-5 from that, at chunk 16 4.4e-6);
  - model logits and cache leaves within atol 1e-4 + rtol 1e-4, greedy
    ids equal where the reference's top-2 margin exceeds 1e-3; decode ≡
    teacher-forced prefill in the port within DECODE_TOL = 1e-4 (2.6e-5
    over all of these);
  - losses within 1e-5; gradients within GRAD_TOL = 5e-5 · max |g| of
    each leaf (mamba2 4.0e-6, zamba2 1.5e-5: the reference itself, run
    on float64 parameters and activations where it does not cast to
    float32, is 1.4e-5 from its float32 run on the same leaf);
  - after each train step the state within the bounds of
    `tests/test_torch_train.py`, float32 moments within MOMENT_TOL = 5e-5
    · max |leaf| (1.6e-5: v ∝ g² doubles g's relative error), the
    elements whose √v̂ is near eps set aside under float32 moments and
    those of `_outside_ill_conditioned` under int8, as
    `tests/test_torch_mla.py` does;
  - converters, remat on ≡ off and the generated ids: bit for bit /
    equal.
"""
import contextlib
import dataclasses
import functools
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import build_model as j_build_model
from repro.models import mamba2 as j_mamba2
from repro.models import split_tree
from repro.models.transformer import _pad_cache_seq as j_pad_cache_seq
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_leaves_to_numpy, lm_params_to_torch,
                                 lm_train_state_to_numpy,
                                 lm_train_state_to_torch)
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, mamba2
from repro_torch.models.transformer import _pad_cache_seq
from repro_torch.train import (AdamWConfig, TrainConfig, generate, greedy,
                               loss_and_grads, make_init_state,
                               make_train_step)

from test_torch_mla import _outside_eps_conditioned
from test_torch_moe import _outside_ill_conditioned, _ref_cache_layers
from test_torch_moe import _ref_state
import test_torch_train
from test_torch_train import (INT8_PARAM_SHARE, _assert_moments_close,
                              _assert_params_close, _leaves, _load_example)

ARCHS = {"mamba2": "mamba2-2.7b", "zamba2": "zamba2-2.7b"}
LAYER_TOL = 1e-5
ATOL = RTOL = 1e-4
MARGIN = 1e-3
DECODE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5
CHUNK_GRAD_TOL = 1e-4
MOMENT_TOL = 5e-5
STEP_F32 = {"lr": 1e-3, "moment_dtype": "float32", "grad_clip": 0.0}
DECODE_STEPS = 6
PREFILL = (3, 18)   # the launcher's context: 10 ids + 8 prompt tokens
TRAIN = (2, 32)     # two chunks of 16: the reference needs a multiple
# the SSM leaves the reference initialises to constants, redrawn
SSM_REDRAW = {"conv_x": 0.5, "conv_B": 0.5, "conv_C": 0.5, "a_log": 1.0,
              "dt_bias": 0.5, "d_skip": 0.1, "norm": 0.1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models' torch ops on one thread: under the suite's
    parallel workers, each worker's default of one thread a core
    oversubscribes the CPU and slows this file ≈6×."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """(port, reference) tiny configs of ARCHS[name], both without remat
    (it halves the reference's trace; the port's remat on ≡ off is its
    own bitwise test)."""
    kw = {"remat": False, **kw}
    arch = ARCHS[name]
    return (dataclasses.replace(get_arch(arch).tiny(), **kw),
            dataclasses.replace(j_get_arch(arch).tiny(), **kw))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def close_of_max(got, want, tol):
    """|got − want| ≤ tol · max |want| everywhere."""
    want = np.asarray(want)
    close(got, want, atol=tol * np.abs(want).max(), rtol=0)


def _redraw(tree, rng):
    """The tree with every SSM_REDRAW leaf redrawn: normal · its scale,
    around 1 for d_skip, uniform in [−1, 1) for a_log (A in [0.37,
    2.7])."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
        elif k == "a_log":
            out[k] = rng.uniform(-1.0, 1.0, v.shape).astype(np.float32)
        elif k in SSM_REDRAW:
            x = rng.standard_normal(v.shape) * SSM_REDRAW[k]
            out[k] = (x + (k == "d_skip")).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _ref(name: str):
    """The reference's model of ARCHS[name] (tiny, chunk 16) and the same
    at `ssm_chunk=18` (one chunk for the launcher's 18-token prompt), its
    init_params(key(0)) with the SSM leaves redrawn, as numpy (drawn once
    for the file), and its jitted prefill (chunk 18), decode step and
    float32 train step without the clip (STEP_F32: the loss test reads the
    gradients off its first step's m, and zamba2's train case runs it)."""
    _, jcfg = _cfgs(name)
    jm = j_build_model(jcfg)
    jm18 = j_build_model(dataclasses.replace(jcfg, ssm_chunk=PREFILL[1]))
    values = _redraw(jax.tree.map(np.asarray, split_tree(
        jm.init_params(jax.random.key(0)))[0]), np.random.default_rng(1))
    return types.SimpleNamespace(
        jm=jm, values=values, prefill18=jax.jit(jm18.prefill),
        decode=jax.jit(jm.decode_step),
        step_f32=jax.jit(j_ts.make_train_step(jm, _j_tc(STEP_F32))))


def _j_tc(kw):
    return j_ts.TrainConfig(opt=j_opt.AdamWConfig(**kw))


# ---------------------------------------------------------- the layer ----
def _layer_params(cfg, rng):
    d, n, k = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    di = cfg.ssm_expand * d
    h = di // cfg.ssm_head_dim
    p = {"wz": rng.standard_normal((d, di)) * d ** -0.5,
         "wx": rng.standard_normal((d, di)) * d ** -0.5,
         "wB": rng.standard_normal((d, n)) * d ** -0.5,
         "wC": rng.standard_normal((d, n)) * d ** -0.5,
         "wdt": rng.standard_normal((d, h)) * d ** -0.5,
         "conv_x": np.zeros((k, di)), "conv_B": np.zeros((k, n)),
         "conv_C": np.zeros((k, n)), "a_log": np.zeros(h),
         "d_skip": np.ones(h), "dt_bias": np.zeros(h), "norm": np.zeros(di),
         "wo": rng.standard_normal((di, d)) * di ** -0.5}
    return _redraw({k: v.astype(np.float32) for k, v in p.items()}, rng)


def _torch_tree(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _rms_normed(rng, shape):
    x = rng.standard_normal(shape)
    return (x / np.sqrt((x ** 2).mean(-1, keepdims=True))).astype(np.float32)


def test_causal_conv_and_ssd_match_reference():
    """`_causal_conv` over [2, 48, 24] with k = 4, and `_ssd_chunked` at S
    = 48 in three chunks of 16 (4 heads of 8, N 8): y and the final
    state."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    close_of_max(
        mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
        j_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(w)), LAYER_TOL)
    b, s, h, p, n = 2, 48, 4, 8, 8
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    jy, jh = jax.jit(j_mamba2._ssd_chunked, static_argnums=4)(
        xdt, a, bb, cc, 16)
    y, hfin = mamba2._ssd_chunked(*map(torch.from_numpy, (xdt, a, bb, cc)),
                                  16)
    assert tuple(hfin.shape) == (b, h, p, n) and hfin.dtype == torch.float32
    close_of_max(y, jy, LAYER_TOL)
    close_of_max(hfin, jh, LAYER_TOL)


def test_forward_state_and_decode_match_reference():
    """`mamba2_forward(return_state=True)` over [2, 32] (two chunks), then
    3 `mamba2_decode` steps from its state: out, h and conv each time."""
    cfg, jcfg = _cfgs("mamba2")
    rng = np.random.default_rng(2)
    p = _layer_params(cfg, rng)
    x = _rms_normed(rng, (2, 35, cfg.d_model))
    s = 32
    jout, jst = jax.jit(lambda prm, xx: j_mamba2.mamba2_forward(
        jcfg, prm, xx, return_state=True))(p, jnp.asarray(x[:, :s]))
    tp = _torch_tree(p)
    out, st = mamba2.mamba2_forward(cfg, tp, torch.from_numpy(x[:, :s]),
                                    return_state=True)
    close_of_max(out, jout, LAYER_TOL)
    assert set(st) == set(jst) == {"h", "conv"}
    for n in st:
        close_of_max(st[n], jst[n], LAYER_TOL)
    jdecode = jax.jit(lambda prm, xx, c: j_mamba2.mamba2_decode(
        jcfg, prm, xx, c, pos=None))
    for t in range(3):
        xt = x[:, s + t:s + t + 1]
        jout, jst = jdecode(p, jnp.asarray(xt), jst)
        out, st = mamba2.mamba2_decode(cfg, tp, torch.from_numpy(xt), st)
        close_of_max(out, jout, LAYER_TOL)
        for n in st:
            close_of_max(st[n], jst[n], LAYER_TOL)


def _layer_grads_ref(jcfg, p, x, r):
    def f(prm):
        return (j_mamba2.mamba2_forward(jcfg, prm, x) * r).sum()
    return jax.jit(jax.value_and_grad(f))(p)


def test_departure_a_gradients_finite_at_a_long_chunk():
    """Departure (a): [2, 128] rms-normed tokens in one chunk of 128, the
    decay per step ≈ 1–3 (a_log drawn in [0.5, 1.5)), so the reference's
    exp above the diagonal overflows: its gradients of a_log, dt_bias and
    wdt are NaN (pinned). The port's, at the same chunk, are all finite
    and equal the reference's at chunk 16 on the same input (SSD does not
    depend on the chunk); the outputs too."""
    cfg, jcfg = _cfgs("mamba2", ssm_chunk=128)
    rng = np.random.default_rng(4)
    p = _layer_params(cfg, rng)
    p["a_log"] = rng.uniform(0.5, 1.5, p["a_log"].shape).astype(np.float32)
    x = _rms_normed(rng, (2, 128, cfg.d_model))
    r = rng.standard_normal(x.shape).astype(np.float32)
    _, jgrads = _layer_grads_ref(jcfg, p, x, r)
    nan = {k for k, g in jgrads.items() if np.isnan(np.asarray(g)).any()}
    assert {"a_log", "dt_bias", "wdt"} <= nan, nan
    jval, want = _layer_grads_ref(dataclasses.replace(jcfg, ssm_chunk=16),
                                  p, x, r)
    tp = {k: v.requires_grad_() for k, v in _torch_tree(p).items()}
    val = (mamba2.mamba2_forward(cfg, tp, torch.from_numpy(x))
           * torch.from_numpy(r)).sum()
    grads = dict(zip(tp, torch.autograd.grad(val, list(tp.values()))))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        close_of_max(g, want[k], CHUNK_GRAD_TOL)


# ---------------------------------------------------------- the model ----
def _assert_greedy(got_logits, want_logits):
    want = np.asarray(want_logits)[:, -1, :]
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > MARGIN
    np.testing.assert_array_equal(greedy(got_logits).numpy()[sure],
                                  want.argmax(-1)[sure])


def _prompt(cfg):
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, PREFILL).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """Departure (b): the reference asserts on a [3, 18] prefill at the
    tiny chunk of 16 (pinned); the port's prefill there (a chunk of 16,
    then one padded) equals the reference's at `ssm_chunk=18`: logits and
    every cache leaf (SSM h and conv, the shared block's K/V). Then 6
    decode steps fed the reference's greedy ids: logits, every cache leaf,
    greedy ids. Then the port's every decode step ≡ a prefill over the
    same prefix."""
    cfg, _ = _cfgs(name)
    ref = _ref(name)
    b, s = PREFILL
    tokens = _prompt(cfg)
    with pytest.raises(AssertionError, match="ssm_chunk"):
        jax.eval_shape(ref.jm.prefill, ref.values,
                       {"tokens": jnp.asarray(tokens)})
    jlogits, jpart = ref.prefill18(ref.values,
                                   {"tokens": jnp.asarray(tokens)})
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    assert cfg.ssm_chunk == 16 and s % cfg.ssm_chunk
    logits, part = model.prefill(torch.from_numpy(tokens))
    close(logits, jlogits)
    _assert_greedy(logits, jlogits)
    want = _ref_cache_layers(jpart, ref.jm)
    assert len(part) == len(want) == len(model.block_types)
    for bt, got, w in zip(model.block_types, part, want):
        assert set(got) == set(w) == (
            {"h", "conv"} if bt.mixer == "ssm" else {"k", "v"})
        for n in w:
            close(got[n], w[n])
    cap = s + DECODE_STEPS
    jcache, _ = split_tree(ref.jm.init_cache(b, cap))
    jcache = j_pad_cache_seq(jcache, jpart)
    cache = _pad_cache_seq(model.init_cache(b, cap), part)
    fed = []
    for t in range(DECODE_STEPS):
        cur = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None].astype(
            np.int32)
        fed.append(cur)
        pos = np.full((b,), s + t, np.int32)
        jlogits, jcache = ref.decode(ref.values, jcache, jnp.asarray(cur),
                                     jnp.asarray(pos), None)
        logits, cache = model.decode_step(cache, torch.from_numpy(cur),
                                          torch.from_numpy(pos))
        close(logits, jlogits)
        _assert_greedy(logits, jlogits)
        for got, w in zip(cache, _ref_cache_layers(jcache, ref.jm)):
            for n in w:
                close(got[n], w[n])
    seq = torch.from_numpy(np.concatenate([tokens] + fed, axis=1))
    run = generate(model, seq[:, :s], DECODE_STEPS, forced=seq[:, s:])
    for t in range(DECODE_STEPS):
        want_t, _ = model.prefill(seq[:, :s + t + 1])
        close(run["logits"][:, t + 1], want_t[:, -1], atol=DECODE_TOL,
              rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_capacity(name):
    """An SSM layer's state has no capacity: mamba2 decodes at positions
    past the cache's length from an int position; zamba2's shared block
    keeps K/V of a capacity, and an int position there raises."""
    cfg, _ = _cfgs(name)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_prompt(cfg))
    b, s = tokens.shape
    _, part = model.prefill(tokens)
    cache = _pad_cache_seq(model.init_cache(b, s), part)
    if name == "mamba2":
        for pos in (s, s + 40):
            logits, cache = model.decode_step(cache, tokens[:, :1], pos)
            assert bool(torch.isfinite(logits).all())
    else:
        with pytest.raises(ValueError, match="capacity of 18 slots"):
            model.decode_step(cache, tokens[:, :1], s)


def test_short_prompt_conv_tail_in_both_packages():
    """Reference caveat (ROADMAP.md Queue 3): after a prompt shorter than
    k − 1 = 3 tokens the prefill's conv tail holds fewer than k − 1 rows,
    and `_pad_cache_seq` places them at slot 0, where the decode's window
    reads them as the oldest: a [3, 2] prefill then a decode of token 2
    differs from a prefill of all 3 tokens (by 3.3 in the logits; after
    3 tokens by 1.5e-6) — in the port as in the reference, whose decode
    logits and cache it equals."""
    cfg, _ = _cfgs("mamba2")
    ref = _ref("mamba2")
    b, s = PREFILL[0], 2
    tokens = _prompt(cfg)[:, :s + 1]
    cap = PREFILL[1] + DECODE_STEPS     # the jitted decode step's shapes
    _, jpart = jax.jit(ref.jm.prefill)(ref.values,
                                       {"tokens": jnp.asarray(tokens[:, :s])})
    jcache, _ = split_tree(ref.jm.init_cache(b, cap))
    jcache = j_pad_cache_seq(jcache, jpart)
    pos = np.full((b,), s, np.int32)
    jlogits, jcache = ref.decode(ref.values, jcache,
                                 jnp.asarray(tokens[:, s:]),
                                 jnp.asarray(pos), None)
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    _, part = model.prefill(torch.from_numpy(tokens[:, :s]))
    assert part[0]["conv"].shape[1] == s < cfg.ssm_conv - 1
    cache = _pad_cache_seq(model.init_cache(b, cap), part)
    logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, s:]),
                                      s)
    close(logits, jlogits)
    for got, w in zip(cache, _ref_cache_layers(jcache, ref.jm)):
        for n in w:
            close(got[n], w[n])
    full, _ = model.prefill(torch.from_numpy(tokens))
    assert float((logits - full).abs().max()) > 1e-2


def _train_tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, TRAIN).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    """`DecoderLM.loss` over [2, 32] tokens (two chunks): loss, ce, aux
    (0) and the gradient of every leaf against `jax.grad` of the
    reference's loss, read off the first step of its float32 train step
    without the clip (m = (1 − b1) · g). zamba2: the shared block's
    gradients sum its two uses; its shared_attn positions' own norm2 and
    FFN, never read, have gradients exactly 0 in both packages."""
    cfg, _ = _cfgs(name)
    ref = _ref(name)
    tokens = _train_tokens(cfg, 3)
    tc = _j_tc(STEP_F32)
    jstate, jmet = ref.step_f32(_ref_state(ref.values, tc),
                                {"tokens": jnp.asarray(tokens)})
    jloss = jmet.pop("loss")
    jgrads = jax.tree.map(lambda m: np.asarray(m) / (1 - tc.opt.b1),
                          jstate["opt"]["m"])
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    loss, met, grads = loss_and_grads(model, dict(model.named_parameters()),
                                      {"tokens": torch.from_numpy(tokens)})
    assert set(met) == set(jmet) == {"ce", "aux"}
    for got, want in [(loss, jloss)] + [(met[k], jmet[k]) for k in jmet]:
        np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    got = _leaves(lm_leaves_to_numpy(model, grads))
    want = _leaves(jgrads)
    assert set(got) == set(want)
    unread = [k for k in want if "/pos2/norm2/" in k or "/pos2/ffn/" in k]
    assert bool(unread) == (name == "zamba2")
    for k in want:
        if k in unread:
            assert not got[k].any() and not want[k].any(), k
            continue
        assert np.abs(want[k]).max() > 0, k
        close_of_max(got[k], want[k], GRAD_TOL)
    if name == "zamba2":
        assert any(k.startswith("/shared/attn/") for k in want)


# (arch, moments, grad_clip): int8 with the clip, float32 without it
TRAIN_CASES = [("mamba2", "int8", 1.0), ("zamba2", "float32", 0.0)]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def test_train_steps_match_reference(case, monkeypatch):
    """2 `make_train_step` steps (grad_accum 1), each from the reference's
    state before it carried by `lm_train_state_to_torch`: each step's
    loss, ce and aux, then every leaf of the state (zamba2: the shared
    block's and the never-read leaves' moments included)."""
    name, moments, clip = case
    monkeypatch.setattr(test_torch_train, "STATE_TOL", MOMENT_TOL)
    cfg, _ = _cfgs(name)
    ref = _ref(name)
    kw = dict(lr=1e-3, moment_dtype=moments, grad_clip=clip)
    jtc = _j_tc(kw)
    tc = TrainConfig(opt=AdamWConfig(**kw))
    jstate = _ref_state(ref.values, jtc)
    jstep = (ref.step_f32 if kw == STEP_F32
             else jax.jit(j_ts.make_train_step(ref.jm, jtc)))
    for i in range(2):
        model, state = lm_train_state_to_torch(
            cfg, tc, jax.tree.map(np.asarray, jstate), device="cpu")
        tokens = _train_tokens(cfg, 20 + i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, met = make_train_step(model, tc)(
            state, {"tokens": torch.from_numpy(tokens)})
        assert set(met) == set(jmet) == {"loss", "ce", "aux"}
        for key in jmet:
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL)
        got = lm_train_state_to_numpy(model, state)
        want = jax.tree.map(np.asarray, jstate)
        assert int(got["step"]) == int(want["step"]) == i + 1
        if moments == "int8":
            params, n_ill, n = _outside_ill_conditioned(got["params"], want)
        else:
            params, n_ill, n = _outside_eps_conditioned(got, want, jtc.opt,
                                                        i + 1)
        assert n_ill <= INT8_PARAM_SHARE * n, (n_ill, n)
        _assert_params_close(params, want["params"], kw["lr"], 1,
                             moments == "int8")
        for which in ("m", "v"):
            _assert_moments_close(got["opt"][which], want["opt"][which],
                                  which, quanta=3)


def test_train_state_round_trip():
    """A zamba2 train state with int8 moments and int8 error feedback: the
    reference's, carried into the port and back, bit for bit (the shared
    block, the SSM leaves and the never-read leaves included); the port's
    own state, after a step, through numpy and back, bit for bit."""
    cfg, _ = _cfgs("zamba2")
    tc = TrainConfig(opt=AdamWConfig(moment_dtype="int8"),
                     grad_compression="int8_ef")
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(moment_dtype="int8"),
                           grad_compression="int8_ef")
    values = jax.tree.map(np.asarray, _ref_state(_ref("zamba2").values, jtc))
    model, state = lm_train_state_to_torch(cfg, tc, values, device="cpu")
    back, want = _leaves(lm_train_state_to_numpy(model, state)), _leaves(
        values)
    assert set(back) == set(want)
    for part in ("/shared/attn/wq/q", "/mixer/conv_x/q", "/pos2/ffn/w_in/q"):
        assert any(part in k for k in want), part
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    tokens = _train_tokens(cfg, 4)
    state, _ = make_train_step(model, tc)(
        state, {"tokens": torch.from_numpy(tokens)})
    once = lm_train_state_to_numpy(model, state)
    model2, state2 = lm_train_state_to_torch(cfg, tc, once, device="cpu")
    twice = _leaves(lm_train_state_to_numpy(model2, state2))
    once = _leaves(once)
    assert np.abs(once["/ef_error/shared/ffn/w_in"]).max() > 0
    for k in once:
        np.testing.assert_array_equal(twice[k], once[k], err_msg=k)


@pytest.mark.parametrize("name", ARCHS)
def test_port_builds_the_reference_tree_serves_and_trains(name):
    """`build_model` on the tiny config (remat on) from a seed: the
    reference's leaf shapes one to one and its parameter count (zamba2's
    never-read leaves included), the SSM leaves at the reference's
    constants; it serves (4 greedy tokens after the 18-token prompt) and
    trains (3 steps at grad_accum 2: every metric finite, the loss
    falling); remat on ≡ off bit for bit."""
    cfg = get_arch(ARCHS[name]).tiny()
    assert cfg.remat
    m1 = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    got = _leaves(lm_leaves_to_numpy(m1, dict(m1.named_parameters())))
    want = _leaves(_ref(name).values)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert sum(p.numel() for p in m1.parameters()) == sum(
        v.size for v in want.values())
    mixer = m1.layers[0]["mixer"]
    assert not mixer["conv_x"].detach().any()
    assert bool((mixer["d_skip"].detach() == 1.0).all())
    run = generate(m1, torch.from_numpy(_prompt(cfg)), 4)
    assert tuple(run["ids"].shape) == (PREFILL[0], 5)
    assert bool(torch.isfinite(run["logits"]).all())
    tokens = {"tokens": torch.from_numpy(_train_tokens(cfg, 6))}
    m2 = build_model(dataclasses.replace(cfg, remat=False), device="cpu",
                     generator=torch.Generator().manual_seed(5))
    (l1, _, g1), (l2, _, g2) = (
        loss_and_grads(m, dict(m.named_parameters()), tokens)
        for m in (m1, m2))
    assert torch.equal(l1, l2) and g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    tc = TrainConfig(opt=AdamWConfig(lr=1e-2), grad_accum=2)
    state, step = make_init_state(m1, tc), make_train_step(m1, tc)
    losses = []
    for _ in range(3):
        state, met = step(state, tokens)
        assert all(bool(torch.isfinite(v)) for v in met.values()), met
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0], losses


def test_generate_arch_zamba2_matches_reference():
    """`launch.serve._generate --arch zamba2-2.7b` on the reference's
    weights (18 context tokens: departure (b)): the reference launcher's
    greedy ids step for step, run at `ssm_chunk=18`; without a model it
    builds the tiny zamba2 from seed 0."""
    cfg, _ = _cfgs("zamba2")
    ref = _ref("zamba2")
    b, gen_len = PREFILL[0], DECODE_STEPS
    reqs = [types.SimpleNamespace(res_idx=np.random.default_rng(i).integers(
        -1, 5000, 10)) for i in range(b)]
    doc_ids = np.stack([np.abs(r.res_idx) % cfg.vocab_size for r in reqs])
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, 8))
    tokens = jnp.asarray(np.concatenate([doc_ids, prompts], axis=1),
                         jnp.int32)
    assert tokens.shape == PREFILL      # the jitted steps' shapes
    logits, part = ref.prefill18(ref.values, {"tokens": tokens})
    cache, _ = split_tree(ref.jm.init_cache(b, tokens.shape[1] + gen_len))
    cache = j_pad_cache_seq(cache, part)
    cur = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
    want = [np.asarray(cur)]
    for t in range(gen_len - 1):
        logits, cache = ref.decode(ref.values, cache, cur, jnp.full(
            (b,), tokens.shape[1] + t, jnp.int32), None)
        cur = jnp.argmax(logits[:, -1, :], -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(cur))
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    args = types.SimpleNamespace(gen_len=gen_len, arch=ARCHS["zamba2"],
                                 device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = serve._generate(args, reqs, model=model)
        own = serve._generate(args, reqs)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    assert own.shape == (b, gen_len)
    assert ((own >= 0) & (own < cfg.vocab_size)).all()
    assert "zamba2-2.7b tiny" in out.getvalue()


@pytest.mark.parametrize("name", ARCHS)
def test_train_launcher_and_example_take_the_arch(name, tmp_path, capsys):
    """`launch/train.py --arch` on the CPU: 2 steps over [2, 24] batches
    (a chunk of 16, then a padded one) with a checkpoint; the example's
    `main --arch` for 2 steps."""
    arch = ARCHS[name]
    launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "24", "--ckpt-every", "2",
                       "--ckpt-dir", str(tmp_path / "launcher")])
    out = capsys.readouterr().out
    assert f"{arch} tiny" in out and out.count("checkpoint -> ") == 1
    _load_example("train_tiny_lm_torch.py").main(
        ["--arch", arch, "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path / "example")])
    out = capsys.readouterr().out
    assert "done. final ce=" in out
