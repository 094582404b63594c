"""Parity of the port's multi-head latent attention (MLA) and multi-token
prediction (MTP) head, and of the deepseek-v3 decoder LM, with the
reference's, on the CPU; and the MoE dispatch's deterministic backward.

Inputs are drawn from seeded numpy generators and go through both
packages. Layer level: `mla_forward` (out, and the latent cache c_kv /
k_rope) and the absorbed `mla_decode` over 4 steps after a prefill (out
and both cache leaves). Model level, on `deepseek-v3-671b.tiny()` (d 64,
4 heads, q_lora 32, kv_lora 32, rope 8, nope 16, v 16, one dense prefix
layer and 3 MoE layers of E = 4, top-2, a shared expert, MTP depth 1)
with the reference's `init_params(key(0))` carried by
`convert.lm_params_to_torch`: a prefill and 6 decode steps (logits, every
latent cache leaf, greedy ids) and the port's decode ≡ a teacher-forced
prefill at capacity factor E/k (nothing drops); `DecoderLM.loss` with
MTP (loss, ce, aux, mtp_ce) and every gradient against `jax.grad`, at
top-2 and at top-8 of 16 experts; 2 `make_train_step` steps (float32
and int8 moments); the converters' round trip of a train state with
int8 moments and error feedback; `build_model`'s own weights in the
reference's tree, remat on ≡ off and a few training steps; the serve
launcher's `_generate --arch deepseek-v3-671b` against the reference's
greedy ids. The dispatch's backward (`ffn._Dispatch`) against autograd's
gather backward and against an explicit slot-order sum.

Tolerances (XLA:CPU and torch sum in different orders; the largest
differences measured are in brackets):
  - MLA layer outputs and cache leaves within atol 1e-5 (prefill
    5.6e-7, decode 6.0e-7);
  - model logits and cache leaves within atol 1e-4 + rtol 1e-4 (3.8e-6),
    greedy ids equal where the reference's top-2 margin exceeds 1e-3;
    decode ≡ teacher-forced prefill in the port within 1e-4 (3.1e-6);
  - losses within 1e-5 (4.8e-7; 1.9e-6 in the train steps), gradients
    within GRAD_TOL · max |g| (top-2: 2.9e-6; top-8: 2.4e-6) — at top-8
    the reference's scatter-add and the port's slot-order sum add a
    token's 8 terms in different orders, so there only a tolerance holds;
  - after each train step the state within the bounds of
    `tests/test_torch_train.py` (moments STATE_TOL · max |leaf|, int8
    levels within 3 quanta, parameters PARAM_STEP_TOL · lr),
    ill-conditioned elements set aside, at most INT8_PARAM_SHARE of
    them: under int8 moments as in `tests/test_torch_moe.py` (28 of
    392,768 in the second step), under float32 moments those whose √v̂
    is below EPS_COND · eps (20 in the first step; one of them, a
    gradient of 2.1e-9 against 1.6e-8, moved 0.45 lr apart);
  - the dispatch backward within 1e-6 of max |g| of autograd's (8.9e-8
    at k = 8, bit for bit at k = 2), and bit for bit an explicit
    slot-order sum;
  - converters, remat on ≡ off and the generated ids: bit for bit / equal.
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
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import split_tree
from repro.models.transformer import _pad_cache_seq as j_pad_cache_seq
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_leaves_to_numpy, lm_params_to_torch,
                                 lm_train_state_to_numpy,
                                 lm_train_state_to_torch)
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, ffn
from repro_torch.models.transformer import _pad_cache_seq
from repro_torch.train import (AdamWConfig, TrainConfig, greedy,
                               loss_and_grads, make_init_state,
                               make_train_step)

from test_torch_moe import (_nest, _outside_ill_conditioned,
                            _ref_cache_layers, _ref_state)
from test_torch_train import (INT8_PARAM_SHARE, _assert_moments_close,
                              _assert_params_close, _leaves)

ARCH = "deepseek-v3-671b"
LAYER_ATOL = 1e-5
ATOL = RTOL = 1e-4
MARGIN = 1e-3
DECODE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
DISPATCH_RTOL = 1e-6
EPS_COND = 10.0
DECODE_STEPS = 6
PREFILL = (3, 18)   # the launcher's context: 10 ids + 8 prompt tokens
# both packages without remat in the parity cases (it halves the
# reference's trace); the port's remat on ≡ off is its own bitwise test
VARIANTS = {"top2": {"remat": False},
            "top8": {"remat": False, "n_experts": 16, "top_k": 8}}


def _cfgs(variant="top2", **kw):
    kw = {**VARIANTS[variant], **kw}
    return (dataclasses.replace(get_arch(ARCH).tiny(), **kw),
            dataclasses.replace(j_get_arch(ARCH).tiny(), **kw))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def _ref(variant: str):
    """The reference's model of a variant, its init_params(key(0)) as
    numpy (drawn once for the file), and its jitted prefill, decode step
    and loss with gradients (shared by the tests that run the same
    shapes)."""
    jm = j_build_model(_cfgs(variant)[1])
    values = jax.tree.map(np.asarray, split_tree(
        jm.init_params(jax.random.key(0)))[0])
    return types.SimpleNamespace(
        jm=jm, values=values, prefill=jax.jit(jm.prefill),
        decode=jax.jit(jm.decode_step),
        loss_grad=jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))


# ---------------------------------------------------------- the layer ----
def _mla_params(cfg, rng):
    d, h = cfg.d_model, cfg.n_heads
    ql, kl, rd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
    nd, vd = cfg.qk_nope_dim, cfg.v_head_dim
    p = {"wq_a": rng.standard_normal((d, ql)) * d ** -0.5,
         "q_norm": rng.standard_normal(ql) * 0.1,
         "wq_b": rng.standard_normal((ql, h * (nd + rd))) * ql ** -0.5,
         "wkv_a": rng.standard_normal((d, kl + rd)) * d ** -0.5,
         "kv_norm": rng.standard_normal(kl) * 0.1,
         "wkv_b": rng.standard_normal((kl, h * (nd + vd))) * kl ** -0.5,
         "wo": rng.standard_normal((h * vd, d)) * (h * vd) ** -0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _torch_tree(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _mla_world(seed, b, s):
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(seed)
    p = _mla_params(cfg, rng)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, x


def test_mla_forward_matches_reference():
    """[2, 12] tokens: the output and the latent cache (c_kv, k_rope)."""
    cfg, jcfg, p, x = _mla_world(0, 2, 12)
    b, s = x.shape[:2]
    pos = np.broadcast_to(np.arange(s), (b, s))
    jout, (jckv, jkr) = jax.jit(lambda prm, xx, pp: j_attn.mla_forward(
        jcfg, prm, xx, positions=pp))(p, jnp.asarray(x), jnp.asarray(pos))
    out, (ckv, kr) = attention.mla_forward(
        cfg, _torch_tree(p), torch.from_numpy(x),
        positions=torch.from_numpy(pos.copy()))
    assert tuple(ckv.shape) == (b, s, cfg.kv_lora_rank)
    assert tuple(kr.shape) == (b, s, cfg.qk_rope_dim)
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        close(got, want, atol=LAYER_ATOL, rtol=0)


def test_mla_decode_matches_reference():
    """A [2, 8] prefill placed in a latent cache of capacity 12, then 4
    absorbed decode steps, each row at its own position: out, c_kv and
    k_rope after every step."""
    cfg, jcfg, p, x = _mla_world(1, 2, 12)
    b, s, cap = 2, 8, 12
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    tp = _torch_tree(p)
    _, (ckv, kr) = attention.mla_forward(
        cfg, tp, torch.from_numpy(x[:, :s]), positions=torch.from_numpy(pos))
    cache = {"c_kv": torch.zeros((b, cap, cfg.kv_lora_rank)),
             "k_rope": torch.zeros((b, cap, cfg.qk_rope_dim))}
    cache["c_kv"][:, :s], cache["k_rope"][:, :s] = ckv, kr
    jcache = {n: jnp.asarray(t.numpy()) for n, t in cache.items()}
    jdecode = jax.jit(lambda prm, xx, c, pp: j_attn.mla_decode(
        jcfg, prm, xx, c, pos=pp))
    for t in range(4):
        at = np.array([s + t, s + t - 1], np.int32)   # rows apart
        xt = x[:, s + t:s + t + 1]
        jout, jcache = jdecode(p, jnp.asarray(xt), jcache, jnp.asarray(at))
        out, cache = attention.mla_decode(cfg, tp, torch.from_numpy(xt),
                                          cache, pos=torch.from_numpy(at))
        close(out, jout, atol=LAYER_ATOL, rtol=0)
        for n in ("c_kv", "k_rope"):
            close(cache[n], jcache[n], atol=LAYER_ATOL, rtol=0)


# ---------------------------------------------------------- the model ----
def _assert_greedy(got_logits, want_logits):
    want = np.asarray(want_logits)[:, -1, :]
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > MARGIN
    np.testing.assert_array_equal(greedy(got_logits).numpy()[sure],
                                  want.argmax(-1)[sure])


def test_prefill_and_decode_match_reference():
    """A [3, 18] prefill, then 6 decode steps fed the reference's greedy
    ids: logits, every latent cache leaf, greedy ids; the MLA blocks'
    caches hold kv_lora + rope values a token and an int position past
    the capacity raises. Then, at capacity factor E/k (no assignment can
    drop), the port's every decode step ≡ a prefill over the same
    prefix."""
    cfg, _ = _cfgs()
    ref = _ref("top2")
    b, s = PREFILL
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    jlogits, jpart = ref.prefill(ref.values, {"tokens": jnp.asarray(tokens)})
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    assert {bt.mixer for bt in model.block_types} == {"mla"}
    logits, part = model.prefill(torch.from_numpy(tokens))
    close(logits, jlogits)
    _assert_greedy(logits, jlogits)
    want = _ref_cache_layers(jpart, ref.jm)
    assert len(part) == len(want) == cfg.n_layers
    for got, w in zip(part, want):
        assert set(got) == set(w) == {"c_kv", "k_rope"}
        for n in w:
            close(got[n], w[n])
    cap = s + DECODE_STEPS
    jcache, _ = split_tree(ref.jm.init_cache(b, cap))
    jcache = j_pad_cache_seq(jcache, jpart)
    cache = _pad_cache_seq(model.init_cache(b, cap), part)
    assert sum(t[0, 0].numel() for t in cache[0].values()) == (
        cfg.kv_lora_rank + cfg.qk_rope_dim)
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
    with pytest.raises(ValueError, match="capacity"):
        model.decode_step(cache, torch.from_numpy(fed[0]), cap)
    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = lm_params_to_torch(no_drop, ref.values, device="cpu")
    seq = torch.from_numpy(np.concatenate([tokens] + fed, axis=1))
    run_logits, part = model.prefill(seq[:, :s])
    cache = _pad_cache_seq(model.init_cache(b, cap), part)
    for t in range(DECODE_STEPS):
        drops = []
        want, _ = model.prefill(seq[:, :s + t + 1], drops=drops)
        assert int(torch.stack(drops).sum()) == 0
        run_logits, cache = model.decode_step(cache, seq[:, s + t:s + t + 1],
                                              s + t)
        close(run_logits, want, atol=DECODE_TOL, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_grads_match_reference(variant):
    """`DecoderLM.loss` with the MTP head over [2, 24] tokens: loss, ce,
    aux (the backbone's MoE blocks only) and mtp_ce, and the gradient of
    every leaf (the MTP block, mtp_proj and mtp_norm included) against
    `jax.grad` of the reference's loss; at top-2 of 4 experts and at top-8
    of 16, where a token sums 8 expert outputs and 8 dispatch gradients."""
    cfg, _ = _cfgs(variant)
    ref = _ref(variant)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (jloss, jmet), jgrads = ref.loss_grad(ref.values,
                                          {"tokens": jnp.asarray(tokens)})
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    loss, met, grads = loss_and_grads(model, dict(model.named_parameters()),
                                      {"tokens": torch.from_numpy(tokens)})
    assert set(met) == set(jmet) == {"ce", "aux", "mtp_ce"}
    for got, want in [(loss, jloss)] + [(met[k], jmet[k]) for k in jmet]:
        np.testing.assert_allclose(float(got), float(want), atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    got = _leaves(lm_leaves_to_numpy(model, grads))
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    assert any(k.startswith("/mtp_block/ffn/") for k in want)
    for k in want:
        close(got[k], want[k], atol=GRAD_TOL * np.abs(want[k]).max(), rtol=0)


# (moments, grad_clip): the float32 case without the clip
TRAIN_CASES = [("float32", 0.0), ("int8", 1.0)]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def test_train_steps_match_reference(case):
    """2 `make_train_step` steps (grad_accum 1), each from the reference's
    state before it carried by `lm_train_state_to_torch` (a parameter
    whose step is ill-conditioned would otherwise carry its difference
    into every gradient of the next step): each step's loss, ce, aux and
    mtp_ce, then every leaf of the state, the MTP leaves' moments
    included."""
    moments, clip = case
    cfg, _ = _cfgs()
    ref = _ref("top2")
    kw = dict(lr=1e-3, moment_dtype=moments, grad_clip=clip)
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(**kw))
    tc = TrainConfig(opt=AdamWConfig(**kw))
    jstate = _ref_state(ref.values, jtc)
    jstep = jax.jit(j_ts.make_train_step(ref.jm, jtc))
    for i in range(2):
        model, state = lm_train_state_to_torch(
            cfg, tc, jax.tree.map(np.asarray, jstate), device="cpu")
        tokens = np.random.default_rng(20 + i).integers(
            0, cfg.vocab_size, (2, 24)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, met = make_train_step(model, tc)(
            state, {"tokens": torch.from_numpy(tokens)})
        assert set(met) == set(jmet) == {"loss", "ce", "aux", "mtp_ce"}
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


def _outside_eps_conditioned(got, want, opt, step):
    """(the port's parameters with the reference's values where either
    package's float32 second moment after `step` steps has 0 < √v̂ <
    EPS_COND · eps, their count, all elements). There |g| is near eps, and
    Adam's step m̂ / (√v̂ + eps) turns a gradient's rounding difference
    (1.4e-8 on a leaf whose max |g| is 0.08, within GRAD_TOL) into up to
    half an lr; where both gradients are 0 (an embedding row no token
    reads) both steps are the decay alone."""
    vg, vw = _leaves(got["opt"]["v"]), _leaves(want["opt"]["v"])
    wp = _leaves(want["params"])
    out, n_ill, n = {}, 0, 0
    for k, g in _leaves(got["params"]).items():
        v = np.minimum(vg[k], vw[k]) / (1 - opt.b2 ** step)
        ill = (np.sqrt(v) < EPS_COND * opt.eps) & ((vg[k] > 0) | (vw[k] > 0))
        out[k] = np.where(ill, wp[k], g)
        n_ill += int(ill.sum())
        n += g.size
    return _nest(out), n_ill, n


def test_train_state_round_trip():
    """A train state with int8 moments and int8 error feedback: the
    reference's, carried into the port and back, bit for bit (every MLA
    and MTP leaf, moments and error feedback included); the port's own
    state, after a step, through numpy and back, bit for bit."""
    cfg, _ = _cfgs()
    tc = TrainConfig(opt=AdamWConfig(moment_dtype="int8"),
                     grad_compression="int8_ef")
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(moment_dtype="int8"),
                           grad_compression="int8_ef")
    values = jax.tree.map(np.asarray, _ref_state(_ref("top2").values, jtc))
    model, state = lm_train_state_to_torch(cfg, tc, values, device="cpu")
    back, want = _leaves(lm_train_state_to_numpy(model, state)), _leaves(
        values)
    assert set(back) == set(want)
    for part in ("/attn/wkv_b/q", "/mtp_proj/q", "/mtp_block/ffn/w_in"):
        assert any(part in k for k in want), part
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    state, _ = make_train_step(model, tc)(
        state, {"tokens": torch.from_numpy(tokens)})
    once = lm_train_state_to_numpy(model, state)
    model2, state2 = lm_train_state_to_torch(cfg, tc, once, device="cpu")
    twice = _leaves(lm_train_state_to_numpy(model2, state2))
    once = _leaves(once)
    assert np.abs(once["/ef_error/mtp_proj"]).max() > 0
    for k in once:
        np.testing.assert_array_equal(twice[k], once[k], err_msg=k)


def test_port_builds_the_reference_tree_and_trains_with_mtp():
    """`build_model` builds deepseek-v3's tiny config from a seed: the
    reference's leaf shapes one to one, the same parameter count, the same
    weights for one seed; remat on ≡ off bit for bit (the MTP block is
    checkpointed too); then 3 steps with MTP: every metric finite and the
    loss falling."""
    cfg = get_arch(ARCH).tiny()
    assert cfg.remat and cfg.mtp and cfg.use_mla
    m1, m2 = (build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(5))
              for _ in range(2))
    got = _leaves(lm_leaves_to_numpy(m1, dict(m1.named_parameters())))
    want = _leaves(_ref("top2").values)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert sum(p.numel() for p in m1.parameters()) == sum(
        v.size for v in want.values())
    for (n, p1), (_, p2) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(p1, p2), n
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 24)))}
    m3 = build_model(dataclasses.replace(cfg, remat=False), device="cpu",
                     generator=torch.Generator().manual_seed(5))
    (l1, x1, g1), (l2, x2, g2) = (
        loss_and_grads(m, dict(m.named_parameters()), tokens)
        for m in (m1, m3))
    assert torch.equal(l1, l2)
    assert all(torch.equal(x1[k], x2[k]) for k in x1)
    assert g1.keys() == g2.keys()
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


def test_generate_arch_deepseek_matches_reference():
    """`launch.serve._generate --arch deepseek-v3-671b` on the reference's
    weights: the reference launcher's greedy ids step for step; without a
    model it builds the tiny deepseek-v3 from seed 0."""
    cfg, _ = _cfgs()
    ref = _ref("top2")
    b, gen_len = PREFILL[0], DECODE_STEPS
    reqs = [types.SimpleNamespace(res_idx=np.random.default_rng(i).integers(
        -1, 5000, 10)) for i in range(b)]
    doc_ids = np.stack([np.abs(r.res_idx) % cfg.vocab_size for r in reqs])
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, 8))
    tokens = jnp.asarray(np.concatenate([doc_ids, prompts], axis=1),
                         jnp.int32)
    assert tokens.shape == PREFILL      # the jitted steps' shapes
    logits, part = ref.prefill(ref.values, {"tokens": tokens})
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
    args = types.SimpleNamespace(gen_len=gen_len, arch=ARCH, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = serve._generate(args, reqs, model=model)
        own = serve._generate(args, reqs)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    assert own.shape == (b, gen_len)
    assert ((own >= 0) & (own < cfg.vocab_size)).all()
    assert f"{ARCH} tiny" in out.getvalue()


# ----------------------------------------------- the dispatch backward ----
def _slot_order_sum(grad, r, k):
    """A token's dispatch gradient as a loop over its slots: g[slot 0] +
    g[slot 1] + ... of the kept ones, in float32, one slot at a time."""
    rows, e, cap, d = grad.shape
    flat = grad.reshape(rows, e * cap, d)
    keep = r.keep.reshape(rows, -1, k)
    slot = (r.expert * cap + r.rank.clamp(max=cap - 1)).reshape(rows, -1, k)
    out = torch.zeros((rows, slot.shape[1], d))
    for j in range(k):
        g = torch.gather(flat, 1, slot[:, :, j, None].expand(-1, -1, d))
        out = out + torch.where(keep[:, :, j, None], g, 0.0)
    return out


@pytest.mark.parametrize("k", [2, 8])
def test_dispatch_backward_is_a_slot_order_sum(k):
    """[2, 40] tokens, 16 experts, top-k, capacity factor 0.5 (some
    assignments drop): the gradient of Σ buf·r through `ffn._dispatch`
    against autograd's backward of the same gather (the scatter-add it
    replaces) within DISPATCH_RTOL of max |g| (at k = 2 bit for bit: two
    terms into zero add alike in any order), and bit for bit against an
    explicit slot-order sum."""
    cfg, _ = _cfgs("top8", top_k=k, capacity_factor=0.5)
    rng = np.random.default_rng(k)
    d = cfg.d_model
    p = {"router": torch.from_numpy(
        (rng.standard_normal((d, cfg.n_experts)) * d ** -0.5)
        .astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((2, 40, d)).astype(np.float32))
    r = ffn.route(cfg, p, x, ffn.capacity(cfg, 40, 8))
    assert int(r.drops.sum()) > 0
    gb = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_experts, r.cap, d)).astype(np.float32))
    xx = x.clone().requires_grad_()
    (got,) = torch.autograd.grad((ffn._dispatch(xx, r, k) * gb).sum(), xx)
    xx = x.clone().requires_grad_()
    e, cap = cfg.n_experts, r.cap
    slot = torch.arange(cap)
    filled = (slot < r.counts[..., None]).reshape(2, e * cap, 1)
    pos = (r.starts[..., None] + slot).clamp(max=r.order.shape[1] - 1)
    tok = torch.gather(r.order, 1, pos.reshape(2, e * cap)) // k
    plain = torch.where(filled, torch.gather(xx, 1, tok[..., None].expand(
        -1, -1, d)), 0.0).reshape(2, e, cap, d)
    (want,) = torch.autograd.grad((plain * gb).sum(), xx)
    assert torch.equal(plain.detach(), ffn._dispatch(x, r, k))
    if k == 2:
        assert torch.equal(got, want)
    else:
        close(got, want, atol=DISPATCH_RTOL * float(want.abs().max()), rtol=0)
    assert torch.equal(got, _slot_order_sum(gb, r, k))
