"""Parity of the port's cross-attention (`models/attention.py`,
`models/transformer.py`) and enc-dec (`models/encdec.py`) with the
reference's, on the CPU: the VLM (llama-3.2-vision-90b) and the enc-dec
(whisper-small).

Inputs are drawn from seeded numpy generators and go through both
packages; memories are unit normal (at the launchers' 0.02 scale the
cross scores are ≈ 0 and the softmax uniform, so a fault on the query
side would not show). Layer level: `attention_forward` over a memory
[2, 24, d] (K/V from the memory, nothing roped, no mask) and
`attention_decode` over its static (ck, cv), 3 tokens; the encoder's
bidirectional self-attention (roped, no mask). Model level, on
`llama-3.2-vision-90b.tiny()` (2 groups of (gqa, gqa + cross), vision_seq
16) and `whisper-small.tiny()` (4 decoder layers of gqa + cross, 2
bidirectional encoder layers, encoder_seq 24, layernorm, GELU), the
reference's `init_params(key(0))` carried by `convert.lm_params_to_torch`:
a [3, 18] prefill and 6 decode steps (logits, every cache leaf including
`ck` / `cv`, greedy ids), the port's decode ≡ a teacher-forced prefill,
`decode_step`'s capacity (the cross cache's Se rows are not one);
whisper's `encode`; `loss` and every gradient against `jax.grad`; 2
`make_train_step` steps at grad_accum 2 (the microbatches split the
memory with the tokens); the converters' train-state round trip. The two
reference behaviours without a memory (the VLM's cross block run as
causal self-attention over the text, whose cache then does not fit;
whisper's `KeyError: 'enc'`, in its prefill and its example) beside the
port's ValueError; the train launcher's batches with `--arch
whisper-small` against the reference launcher's; the serve launcher's
`_generate` and the example refusing both families.

Tolerances (XLA:CPU and torch sum in different orders; the largest
differences measured are in brackets):
  - layer outputs and caches within LAYER_TOL = 1e-5 · max |.| (cross
    forward and decode 4.6e-7, bidirectional 2.1e-7);
  - model logits and cache leaves within atol 1e-4 + rtol 1e-4 (VLM
    5.0e-6, whisper 2.5e-6), greedy ids equal where the reference's top-2
    margin exceeds 1e-3; decode ≡ teacher-forced prefill in the port
    within DECODE_TOL = 1e-4 (2.2e-6); `encode` within LAYER_TOL · max
    |.| (3.5e-7);
  - losses within 1e-5; gradients within GRAD_TOL = 5e-5 · max |g| of
    each leaf (VLM 1.5e-6, whisper 1.2e-6);
  - after each train step the state within the bounds of
    `tests/test_torch_train.py`, float32 moments within MOMENT_TOL = 5e-5
    · max |leaf| (v ∝ g² doubles g's relative error), the elements whose
    √v̂ is near eps set aside as `tests/test_torch_mla.py` does;
  - converters, remat on ≡ off and the launchers' batches: bit for bit.
"""
import contextlib
import dataclasses
import functools
import io
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import split_tree
from repro.models.common import P
from repro.models.transformer import _pad_cache_seq as j_pad_cache_seq
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_leaves_to_numpy, lm_params_to_torch,
                                 lm_train_state_to_numpy,
                                 lm_train_state_to_torch)
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import EncDecLM, attention, build_model
from repro_torch.models.transformer import _pad_cache_seq, cross_len
from repro_torch.train import (AdamWConfig, TrainConfig, generate, greedy,
                               loss_and_grads, make_init_state,
                               make_train_step)

from test_torch_mla import _outside_eps_conditioned
from test_torch_moe import _ref_cache_layers, _ref_state
import test_torch_train
from test_torch_train import (INT8_PARAM_SHARE, _assert_moments_close,
                              _assert_params_close, _leaves, _load_example)

ARCHS = {"vlm": "llama-3.2-vision-90b", "whisper": "whisper-small"}
LAYER_TOL = 1e-5
ATOL = RTOL = 1e-4
MARGIN = 1e-3
DECODE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5
MOMENT_TOL = 5e-5
STEP_F32 = {"lr": 1e-3, "moment_dtype": "float32", "grad_clip": 0.0}
ACCUM = 2
DECODE_STEPS = 6
PREFILL = (3, 18)   # the launcher's context: 10 ids + 8 prompt tokens
TRAIN = (4, 16)     # two microbatches of 2 rows


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models' torch ops on one thread: under the suite's
    parallel workers, each worker's default of one thread a core
    oversubscribes the CPU."""
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


def _j_tc(kw, **extra):
    return j_ts.TrainConfig(opt=j_opt.AdamWConfig(**kw), **extra)


@functools.lru_cache(maxsize=None)
def _ref(name: str):
    """The reference's tiny model of ARCHS[name], its init_params(key(0))
    as numpy (drawn once for the file), and its jitted prefill, decode
    step, float32 train step at grad_accum ACCUM without the clip
    (STEP_F32: the gradient test reads the gradients off its first
    step's m) and, for whisper, `encode`."""
    _, jcfg = _cfgs(name)
    jm = j_build_model(jcfg)
    values = jax.tree.map(np.asarray, split_tree(
        jm.init_params(jax.random.key(0)))[0])
    return types.SimpleNamespace(
        jm=jm, values=values, prefill=jax.jit(jm.prefill),
        decode=jax.jit(jm.decode_step),
        encode=jax.jit(jm.encode) if name == "whisper" else None,
        step=jax.jit(j_ts.make_train_step(
            jm, _j_tc(STEP_F32, grad_accum=ACCUM))))


def _memory(cfg, b, seed):
    """A unit-normal memory [b, Se, d] (frames for whisper)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cross_len(cfg), cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------- the layer ----
def _attn_params(cfg, rng):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
              "wo": (h * hd, d)}
    return {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


def _torch_tree(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_cross_attention_forward_and_decode_match_reference():
    """`attention_forward` with a memory [2, 24, d] (kv_override) over 6
    query tokens at positions 5..10 — nothing roped, every row seen —:
    out and (k, v); then 3 `attention_decode` steps at positions 11..13
    over that static (ck, cv): out, and the cache returned unchanged."""
    cfg, jcfg = _cfgs("vlm")
    rng = np.random.default_rng(0)
    p = _attn_params(cfg, rng)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 11), (2, 6)).astype(np.int32)
    jout, (jk, jv) = jax.jit(lambda prm, xx, e, ps: j_attn.attention_forward(
        jcfg, prm, xx, positions=ps, kv_override=e))(
        p, jnp.asarray(x[:, :6]), jnp.asarray(enc), jnp.asarray(pos))
    tp = _torch_tree(p)
    out, (k, v) = attention.attention_forward(
        cfg, tp, torch.from_numpy(x[:, :6]), positions=torch.from_numpy(pos),
        kv_override=torch.from_numpy(enc))
    assert tuple(k.shape) == (2, 24, cfg.n_kv_heads, cfg.hd)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        close_of_max(got, want, LAYER_TOL)
    jdecode = jax.jit(lambda prm, xx, ps, ck, cv: j_attn.attention_decode(
        jcfg, prm, xx, None, pos=ps, cross_kv=(ck, cv))[0])
    cache = {"ck": k, "cv": v}
    for t in range(3):
        xt = x[:, 6 + t:7 + t]
        ps = np.full((2,), 11 + t, np.int32)
        want = jdecode(p, jnp.asarray(xt), jnp.asarray(ps), jk, jv)
        got, back = attention.attention_decode(
            cfg, tp, torch.from_numpy(xt), cache, pos=torch.from_numpy(ps),
            cross_kv=(k, v))
        assert back is cache
        close_of_max(got, want, LAYER_TOL)


def test_bidirectional_self_attention_matches_reference():
    """The encoder's self-attention, `causal=False` without a memory, over
    [2, 24, d] at positions 0..23: roped, no mask — out and (k, v); and
    the last position's output differs from the causal one's only there
    (it already sees every key)."""
    cfg, jcfg = _cfgs("whisper")
    rng = np.random.default_rng(1)
    p = _attn_params(cfg, rng)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    jout, (jk, jv) = jax.jit(lambda prm, xx, ps: j_attn.attention_forward(
        jcfg, prm, xx, positions=ps, causal=False))(
        p, jnp.asarray(x), jnp.asarray(pos))
    tp = _torch_tree(p)
    args = (cfg, tp, torch.from_numpy(x))
    out, (k, v) = attention.attention_forward(
        *args, positions=torch.from_numpy(pos), causal=False)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        close_of_max(got, want, LAYER_TOL)
    causal, _ = attention.attention_forward(*args,
                                            positions=torch.from_numpy(pos))
    diff = (out - causal).abs().amax(dim=(0, 2))
    assert float(diff[-1]) < 1e-5 < float(diff[:-1].min())


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
    """A [3, 18] prefill over a memory (the VLM's prompt longer than its
    16 memory rows): logits and every cache leaf (self K/V; ck / cv of
    the cross blocks, Se rows). Then 6 decode steps fed the reference's
    greedy ids: logits, every cache leaf, greedy ids. Then the port's
    every decode step ≡ a prefill over the same prefix and memory; an int
    position at the self-attention capacity raises (the cross cache's Se
    rows are no capacity)."""
    cfg, _ = _cfgs(name)
    ref = _ref(name)
    b, s = PREFILL
    tokens, enc = _prompt(cfg), _memory(cfg, b, 8)
    jlogits, jpart = ref.prefill(ref.values, {"tokens": jnp.asarray(tokens),
                                              "enc": jnp.asarray(enc)})
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    assert isinstance(model, EncDecLM) == (name == "whisper")
    logits, part = model.prefill(torch.from_numpy(tokens),
                                 enc=torch.from_numpy(enc))
    close(logits, jlogits)
    _assert_greedy(logits, jlogits)
    want = _ref_cache_layers(jpart, ref.jm)
    assert len(part) == len(want) == len(model.block_types)
    for bt, got, w in zip(model.block_types, part, want):
        assert set(got) == set(w) == (
            {"k", "v", "ck", "cv"} if bt.cross else {"k", "v"})
        for n in w:
            close(got[n], w[n])
    assert sum(bt.cross for bt in model.block_types) == (
        2 if name == "vlm" else 4)
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
    with pytest.raises(ValueError, match=f"capacity of {cap} slots"):
        model.decode_step(cache, torch.from_numpy(cur), cap)
    seq = torch.from_numpy(np.concatenate([tokens] + fed, axis=1))
    mem = torch.from_numpy(enc)
    run = generate(model, seq[:, :s], DECODE_STEPS, forced=seq[:, s:],
                   enc=mem)
    for t in range(DECODE_STEPS):
        want_t, _ = model.prefill(seq[:, :s + t + 1], enc=mem)
        close(run["logits"][:, t + 1], want_t[:, -1], atol=DECODE_TOL,
              rtol=0)


def test_encode_matches_reference():
    """whisper's `encode` over frames [3, 24, d]: the bidirectional stack
    and enc_norm."""
    cfg, _ = _cfgs("whisper")
    ref = _ref("whisper")
    frames = _memory(cfg, 3, 9)
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    with torch.no_grad():
        got = model.encode(torch.from_numpy(frames))
    close_of_max(got, ref.encode(ref.values, jnp.asarray(frames)), LAYER_TOL)


def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, TRAIN).astype(np.int32),
            "enc": _memory(cfg, TRAIN[0], seed + 100)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    """`loss_and_grads` at grad_accum 2 over [4, 16] tokens and their
    memory (both split into 2 microbatches): the last microbatch's loss,
    ce and aux (0), and the gradient of every leaf (the cross blocks' and
    whisper's encoder's included) against `jax.grad` of the reference's
    loss, read off the first step of its float32 train step without the
    clip (m = (1 − b1) · mean g)."""
    cfg, _ = _cfgs(name)
    ref = _ref(name)
    batch = _train_batch(cfg, 3)
    tc = _j_tc(STEP_F32)
    jstate, jmet = ref.step(_ref_state(ref.values, tc),
                            jax.tree.map(jnp.asarray, batch))
    jloss = jmet.pop("loss")
    jgrads = jax.tree.map(lambda m: np.asarray(m) / (1 - tc.opt.b1),
                          jstate["opt"]["m"])
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    loss, met, grads = loss_and_grads(model, dict(model.named_parameters()),
                                      _torch_batch(batch), grad_accum=ACCUM)
    assert set(met) == set(jmet) == {"ce", "aux"}
    for got, want in [(loss, jloss)] + [(met[k], jmet[k]) for k in jmet]:
        np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    got = _leaves(lm_leaves_to_numpy(model, grads))
    want = _leaves(jgrads)
    assert set(got) == set(want)
    for part in ("/cross/wk", "/norm_cross/scale") + (
            ("/enc_blocks/attn/wq", "/enc_norm/bias") if name == "whisper"
            else ()):
        assert any(part in k for k in want), part
    for k in want:
        assert np.abs(want[k]).max() > 0, k
        close_of_max(got[k], want[k], GRAD_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_train_steps_match_reference(name, monkeypatch):
    """2 `make_train_step` steps at grad_accum 2 (float32 moments, no
    clip), each from the reference's state before it carried by
    `lm_train_state_to_torch`: each step's loss, ce and aux, then every
    leaf of the state. A `loss_and_grads` that passed the microbatches'
    tokens alone would raise here (the memory missing)."""
    monkeypatch.setattr(test_torch_train, "STATE_TOL", MOMENT_TOL)
    cfg, _ = _cfgs(name)
    ref = _ref(name)
    jtc = _j_tc(STEP_F32)
    tc = TrainConfig(opt=AdamWConfig(**STEP_F32), grad_accum=ACCUM)
    jstate = _ref_state(ref.values, jtc)
    for i in range(2):
        model, state = lm_train_state_to_torch(
            cfg, tc, jax.tree.map(np.asarray, jstate), device="cpu")
        batch = _train_batch(cfg, 20 + i)
        jstate, jmet = ref.step(jstate, jax.tree.map(jnp.asarray, batch))
        state, met = make_train_step(model, tc)(state, _torch_batch(batch))
        assert set(met) == set(jmet) == {"loss", "ce", "aux"}
        for key in jmet:
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL)
        got = lm_train_state_to_numpy(model, state)
        want = jax.tree.map(np.asarray, jstate)
        assert int(got["step"]) == int(want["step"]) == i + 1
        params, n_ill, n = _outside_eps_conditioned(got, want, jtc.opt, i + 1)
        assert n_ill <= INT8_PARAM_SHARE * n, (n_ill, n)
        _assert_params_close(params, want["params"], STEP_F32["lr"], 1,
                             False)
        for which in ("m", "v"):
            _assert_moments_close(got["opt"][which], want["opt"][which],
                                  which)


@pytest.mark.parametrize("name", ARCHS)
def test_train_state_round_trip(name):
    """A train state with int8 moments and int8 error feedback: the
    reference's, carried into the port and back, bit for bit (the cross
    blocks' leaves, whisper's stacked `enc_blocks` and `enc_norm`
    included); the port's own state, after a step, through numpy and
    back, bit for bit."""
    cfg, _ = _cfgs(name)
    tc = TrainConfig(opt=AdamWConfig(moment_dtype="int8"),
                     grad_compression="int8_ef")
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(moment_dtype="int8"),
                           grad_compression="int8_ef")
    values = jax.tree.map(np.asarray, _ref_state(_ref(name).values, jtc))
    model, state = lm_train_state_to_torch(cfg, tc, values, device="cpu")
    back, want = _leaves(lm_train_state_to_numpy(model, state)), _leaves(
        values)
    assert set(back) == set(want)
    parts = ["/cross/wq/q", "/norm_cross/scale/q"] + (
        ["/enc_blocks/ffn/w_in/q", "/enc_norm/bias/q"] if name == "whisper"
        else [])
    for part in parts:
        assert any(part in k for k in want), part
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    state, _ = make_train_step(model, tc)(
        state, _torch_batch(_train_batch(cfg, 4)))
    once = lm_train_state_to_numpy(model, state)
    model2, state2 = lm_train_state_to_torch(cfg, tc, once, device="cpu")
    twice = _leaves(lm_train_state_to_numpy(model2, state2))
    once = _leaves(once)
    for k in once:
        np.testing.assert_array_equal(twice[k], once[k], err_msg=k)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_on_equals_off_and_serves(name):
    """`build_model` on the tiny config (remat on, whisper's encoder layers
    checkpointed too) ≡ remat off, bit for bit: the loss and every
    gradient at grad_accum 2; the model serves 4 greedy tokens from a
    seed."""
    cfg = get_arch(ARCHS[name]).tiny()
    assert cfg.remat
    m1, m2 = (build_model(c, device="cpu",
                          generator=torch.Generator().manual_seed(5))
              for c in (cfg, dataclasses.replace(cfg, remat=False)))
    batch = _torch_batch(_train_batch(cfg, 6))
    (l1, _, g1), (l2, _, g2) = (
        loss_and_grads(m, dict(m.named_parameters()), batch, ACCUM)
        for m in (m1, m2))
    assert torch.equal(l1, l2) and g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    run = generate(m1, torch.from_numpy(_prompt(cfg)), 4,
                   enc=torch.from_numpy(_memory(cfg, PREFILL[0], 8)))
    assert tuple(run["ids"].shape) == (PREFILL[0], 5)
    assert bool(torch.isfinite(run["logits"]).all())


# ------------------------------------------------- without a memory ----
def test_vlm_without_memory_reference_caveat_and_port_raises():
    """Reference caveat (ROADMAP.md Queue 3): the VLM's prefill without
    `enc` runs its cross blocks as causal, roped self-attention over the
    text and caches a `ck` of the prompt's length; at 18 tokens that does
    not fit the cache's 16 memory rows (`_pad_cache_seq` raises
    TypeError), at 10 it fills 10 of them and decode attends over 6 zero
    rows. The port's `prefill` and `loss` raise ValueError instead."""
    cfg, _ = _cfgs("vlm")
    ref = _ref("vlm")
    b, s = PREFILL
    tokens = _prompt(cfg)
    cache, _ = split_tree(ref.jm.init_cache(b, s + 2))
    for n, fits in ((s, False), (10, True)):
        _, part = jax.eval_shape(ref.jm.prefill, ref.values,
                                 {"tokens": jnp.asarray(tokens[:, :n])})
        assert part["seg0"]["pos1"]["ck"].shape[2] == n != cfg.vision_seq
        if fits:
            jax.eval_shape(j_pad_cache_seq, cache, part)
        else:
            with pytest.raises(TypeError, match="dynamic_update_slice"):
                jax.eval_shape(j_pad_cache_seq, cache, part)
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    with pytest.raises(ValueError, match="cross-attention memory"):
        model.prefill(torch.from_numpy(tokens))
    with pytest.raises(ValueError, match="cross-attention memory"):
        model.loss({"tokens": torch.from_numpy(tokens)})


def test_whisper_without_frames_reference_raises_keyerror(monkeypatch):
    """Reference caveat (ROADMAP.md Queue 3): whisper's prefill without
    `enc` raises KeyError('enc'), and so does the reference example with
    `--arch whisper-small` (its batches carry tokens alone). The port's
    `prefill` and `loss` raise ValueError, naming the frames."""
    cfg, _ = _cfgs("whisper")
    ref = _ref("whisper")
    tokens = _prompt(cfg)
    with pytest.raises(KeyError, match="enc"):
        jax.eval_shape(ref.jm.prefill, ref.values,
                       {"tokens": jnp.asarray(tokens)})
    monkeypatch.setattr(sys, "argv", ["train_tiny_lm.py", "--arch",
                                      ARCHS["whisper"], "--steps", "1"])
    with pytest.raises(KeyError, match="enc"):
        _load_example("train_tiny_lm.py").main()
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    with pytest.raises(ValueError, match="input frames"):
        model.prefill(torch.from_numpy(tokens))
    with pytest.raises(ValueError, match="input frames"):
        model.loss({"tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("name", ARCHS)
def test_generate_and_example_refuse_cross_families(name, tmp_path):
    """`launch.serve._generate` (the RAG tail feeds tokens alone) and the
    example (Markov token batches) raise ValueError for a model that
    cross-attends, naming its memory, before building anything."""
    reqs = [types.SimpleNamespace(res_idx=np.arange(10))]
    args = types.SimpleNamespace(gen_len=4, arch=ARCHS[name], device="cpu")
    memory = "image patch" if name == "vlm" else "audio frames"
    with pytest.raises(ValueError, match=memory):
        serve._generate(args, reqs)
    with pytest.raises(ValueError, match=memory):
        _load_example("train_tiny_lm_torch.py").main(
            ["--arch", ARCHS[name], "--device", "cpu", "--steps", "1",
             "--ckpt-dir", str(tmp_path)])


def test_train_launcher_batches_match_reference(monkeypatch, tmp_path,
                                                capsys):
    """`launch/train.py --arch whisper-small` on the CPU for 2 steps of
    [2, 16]: each step's tokens and stub frames, 0.02 · N(0, 1) [2, 24,
    d] drawn right after them from the same generator, equal the
    reference launcher's bit for bit (its step recorded, not run, and its
    state a placeholder: only the draws are compared); the port's steps
    run and checkpoint."""
    import repro.launch.train as j_launch_train
    import repro_torch.train as port_train

    argv = ["--arch", ARCHS["whisper"], "--steps", "2", "--batch", "2",
            "--seq", "16"]
    seen = {"port": [], "ref": []}

    def port_step(model, tc):
        step = make_train_step(model, tc)

        def run(state, batch):
            seen["port"].append({k: v.numpy().copy()
                                 for k, v in batch.items()})
            return step(state, batch)
        return run

    def ref_init(model, tc):
        return lambda key: {"step": P(jnp.zeros((), jnp.int32), ())}

    def ref_step(model, tc):
        def run(state, batch):
            jax.debug.callback(lambda t, e: seen["ref"].append(
                {"tokens": np.asarray(t), "enc": np.asarray(e)}),
                batch["tokens"], batch["enc"])
            return state, {"loss": jnp.float32(0.0)}
        return run

    monkeypatch.setattr(port_train, "make_train_step", port_step)
    monkeypatch.setattr(j_ts, "make_train_step", ref_step)
    monkeypatch.setattr(j_ts, "make_init_state", ref_init)
    launch_train.main(argv + ["--device", "cpu", "--ckpt-every", "2",
                              "--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert f"{ARCHS['whisper']} tiny" in out
    assert out.count("checkpoint -> ") == 1
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv + [
        "--ckpt-dir", str(tmp_path / "ref")])
    j_launch_train.main()
    jax.effects_barrier()
    assert len(seen["port"]) == len(seen["ref"]) == 2
    cfg = get_arch(ARCHS["whisper"]).tiny()
    for got, want in zip(seen["port"], seen["ref"]):
        assert got["enc"].shape == (2, cfg.encoder_seq, cfg.d_model)
        for k in ("tokens", "enc"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
