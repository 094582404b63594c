"""Parity of the port's sort-based dropping MoE (`repro_torch.models.ffn`)
and of the MoE decoder LM with the reference's, on the CPU.

Inputs are drawn from seeded numpy generators and go through both
packages. Layer level: `moe_forward` per row and global
(`REPRO_MOE_GLOBAL=1` on both sides), without drops (capacity_factor
1.25) and with them (0.25), with and without a shared expert: the output,
the aux loss, the expert ids and the keep mask (the reference's routing
transcribed in jnp), and every gradient of Σ out·r + aux against
`jax.grad`; equal router probabilities route to the lower expert id
first. Model level, on `phi3.5-moe-42b-a6.6b.tiny()` (E = 4, k = 2, f =
64, d 64, 4 layers) and on it with a dense prefix layer and a shared
expert: the reference's `init_params(key(0))` carried by
`convert.lm_params_to_torch`, a prefill and 6 teacher-forced decode steps
(logits, every cache leaf, greedy ids); 3 train steps on the second
(float32 moments without the clip, with `loss_and_grads`'s gradients
against the first step's m / (1 − b1); int8 moments), both packages
without remat there; remat on ≡ off; `build_model`'s own
weights in the reference's tree; a train state's checkpoint across the
packages; the launcher's
`_generate --arch phi3.5-moe-42b-a6.6b`, and the decode ≢ prefill caveat
under drops (ROADMAP.md Queue 3).

Tolerances (XLA:CPU and torch sum in different orders; the largest
differences measured are in brackets):
  - layer outputs within atol 1e-5 (4.8e-7), aux within rtol 1e-6 (0),
    each gradient leaf within GRAD_TOL · its max |g| (3.0e-7);
  - expert ids and keep masks equal; the seeded inputs' router margins
    (the gaps between the first k + 1 sorted probabilities) all exceed
    ROUTE_MARGIN = 1e-6, which each test asserts, so no id can flip;
  - model logits and cache leaves within atol 1e-4 + rtol 1e-4 (4.8e-6),
    greedy ids equal where the reference's top-2 margin exceeds 1e-3;
  - losses within 1e-5 (9.5e-7), gradients within GRAD_TOL · max |g|
    (2.1e-6); after 3 train steps the state within the bounds of
    `tests/test_torch_train.py`: moments STATE_TOL · max |leaf| (3.8e-6),
    int8 moment levels within 3 quanta, parameters PARAM_STEP_TOL · lr ·
    steps (0.017), under int8 moments all within lr · steps and all but
    INT8_PARAM_SHARE within PARAM_STEP_TOL · lr · steps, elements whose
    int8 step is ill-conditioned set aside (`_outside_ill_conditioned`:
    2 of 292,160, neither past 0.017 here);
  - remat on ≡ off, checkpoints and the generated ids: bit for bit / equal.
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
from repro.models import ffn as j_ffn
from repro.models import split_tree
from repro.models.common import P
from repro.models.transformer import _pad_cache_seq as j_pad_cache_seq
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch.configs import get_arch
from repro_torch.convert import (lm_leaves_to_numpy, lm_params_to_torch,
                                 lm_train_state_to_numpy,
                                 lm_train_state_to_torch)
from repro_torch.launch import serve
from repro_torch.models import build_model, ffn
from repro_torch.models.transformer import _pad_cache_seq
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainConfig,
                               greedy, loss_and_grads, make_train_step)

from test_torch_train import (INT8_PARAM_SHARE,
                              _assert_moments_close, _assert_params_close,
                              _leaves)

ARCH = "phi3.5-moe-42b-a6.6b"
OUT_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_TOL = 1e-5
ROUTE_MARGIN = 1e-6
ATOL = RTOL = 1e-4
MARGIN = 1e-3
LOSS_TOL = 1e-5
DECODE_STEPS = 6
VARIANTS = {"tiny": {},
            "prefix-shared": {"first_dense_layers": 1, "n_shared_experts": 1}}


def _cfgs(variant="tiny", **kw):
    kw = {**VARIANTS[variant], **kw}
    return (dataclasses.replace(get_arch(ARCH).tiny(), **kw),
            dataclasses.replace(j_get_arch(ARCH).tiny(), **kw))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------- the layer ----
def _layer_params(cfg, rng):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_in": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_out": rng.standard_normal((e, f, d)) * f ** -0.5}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_in": rng.standard_normal((d, fs)) * d ** -0.5,
                       "w_gate": rng.standard_normal((d, fs)) * d ** -0.5,
                       "w_out": rng.standard_normal((fs, d)) * fs ** -0.5}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _ref_routing(jcfg, p, x, glob: bool):
    """The reference's routing (`repro/models/ffn.py`), transcribed in jnp:
    (expert ids [R, S·k] in (token, slot) order, keep mask in that order,
    the smallest gap among each token's first k + 1 sorted
    probabilities)."""
    ids, keep, gap = jax.jit(_ref_routing_fn, static_argnums=(0, 3))(
        jcfg, jnp.asarray(p["router"]), jnp.asarray(x), glob)
    return np.asarray(ids), np.asarray(keep), float(gap)


def _ref_routing_fn(jcfg, router, x, glob):
    b, s, d = x.shape
    e, k = jcfg.n_experts, jcfg.top_k
    xr = x.reshape(1, b * s, d) if glob else x
    rows, t = xr.shape[:2]
    logits = jnp.einsum("bsd,de->bse", xr, router)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, gate_e = jax.lax.top_k(probs, k)
    cap = int(jcfg.capacity_factor * k * t / e) + 1
    mult = 16 if glob else 8
    cap = -(-cap // mult) * mult
    flat_e = gate_e.reshape(rows, t * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    starts = jax.vmap(lambda r: jnp.searchsorted(r, jnp.arange(e)))(se)
    rank = jnp.arange(t * k)[None] - jnp.take_along_axis(starts, se, axis=1)
    keep = jnp.zeros((rows, t * k), bool).at[
        jnp.arange(rows)[:, None], order].set(rank < cap)
    top = -jnp.sort(-probs, axis=-1)[..., :k + 1]
    return flat_e, keep, jnp.min(top[..., :-1] - top[..., 1:])


def _port_routing(cfg, p, x, glob: bool):
    b, s, d = x.shape
    xr = x.reshape(1, b * s, d) if glob else x
    cap = ffn.capacity(cfg, xr.shape[1], 16 if glob else 8)
    r = ffn.route(cfg, p, xr, cap)
    return r.expert.numpy(), r.keep.numpy(), int(r.drops.sum())


def _torch_tree(p, grad=False):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(grad), p)


def _layer_parity(monkeypatch, cfg, jcfg, p, x, glob):
    """moe_forward in both packages; returns the port's drops."""
    if glob:
        monkeypatch.setenv("REPRO_MOE_GLOBAL", "1")
    else:
        monkeypatch.delenv("REPRO_MOE_GLOBAL", raising=False)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def j_loss(prm, xx):
        out, aux = j_ffn.moe_forward(jcfg, prm, xx, return_aux=True)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _torch_tree(p, grad=True)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out, aux = ffn.moe_forward(cfg, tp, tx, return_aux=True)
    leaves = jax.tree.leaves(tp) + [tx]
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum() + aux,
                                leaves)
    close(out.detach(), jout, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux),
                               rtol=AUX_RTOL)
    for got, want in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        want = np.asarray(want)
        close(got, want, atol=GRAD_TOL * np.abs(want).max(), rtol=0)
    with torch.no_grad():
        ids, keep, drops = _port_routing(cfg, tp, tx, glob)
    want_ids, want_keep, margin = _ref_routing(jcfg, p, x, glob)
    assert margin > ROUTE_MARGIN, margin
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(keep, want_keep)
    return drops


LAYER_CASES = {"row": (False, 1.25, 0), "row-drops": (False, 0.25, 0),
               "global": (True, 1.25, 0), "global-drops": (True, 0.25, 0),
               "row-shared-drops": (False, 0.25, 1)}


@pytest.mark.parametrize("case", LAYER_CASES)
def test_moe_forward_matches_reference(case, monkeypatch):
    """[2, 64] tokens through E = 4 experts, top-2: at capacity_factor
    1.25 no assignment drops (row cap 48, global cap 96); at 0.25 some do
    (row cap 16, global cap 32). Output, aux, ids, keep and gradients."""
    glob, cf, shared = LAYER_CASES[case]
    cfg, jcfg = _cfgs(capacity_factor=cf, n_shared_experts=shared)
    rng = np.random.default_rng(0)
    p = _layer_params(cfg, rng)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    drops = _layer_parity(monkeypatch, cfg, jcfg, p, x, glob)
    assert (drops > 0) == (cf < 1.0), drops


@pytest.mark.parametrize("glob", [False, True], ids=["row", "global"])
def test_equal_probabilities_route_to_the_lower_expert(glob, monkeypatch):
    """Router columns 2 and 3 copy columns 0 and 1, so every token's top
    two probabilities tie: ids (lower first), keep, output and gradients
    equal the reference's; a zero router ties all four experts, so every
    token routes to experts 0 and 1 and the rest of each expert's tokens
    past the capacity drop."""
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(2)
    p = _layer_params(cfg, rng)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    r = p["router"]
    r[:, 2:] = r[:, :2]
    tp = _torch_tree(p)
    ids, _, _ = _port_routing(cfg, tp, torch.from_numpy(x), glob)
    assert (ids.reshape(-1, 2)[:, 0] < ids.reshape(-1, 2)[:, 1]).all()
    np.testing.assert_array_equal(ids, _ref_routing(jcfg, p, x, glob)[0])
    p["router"] = np.zeros_like(r)
    tp = _torch_tree(p)
    ids, keep, drops = _port_routing(cfg, tp, torch.from_numpy(x), glob)
    want_ids, want_keep, _ = _ref_routing(jcfg, p, x, glob)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(keep, want_keep)
    assert (ids.reshape(-1, 2) == [0, 1]).all() and drops > 0
    if glob:
        monkeypatch.setenv("REPRO_MOE_GLOBAL", "1")
    want = jax.jit(lambda prm, xx: j_ffn.moe_forward(jcfg, prm, xx))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(ffn.moe_forward(cfg, tp, torch.from_numpy(x)), want,
          atol=OUT_ATOL, rtol=0)


# ---------------------------------------------------------- the model ----
@functools.lru_cache(maxsize=None)
def _ref(variant: str):
    """The reference's model of a variant, its init_params(key(0)) as
    numpy (drawn once for the file), and its jitted prefill and decode
    step (shared by the tests that run the same shapes)."""
    jm = j_build_model(_cfgs(variant)[1])
    values = jax.tree.map(np.asarray, split_tree(
        jm.init_params(jax.random.key(0)))[0])
    return types.SimpleNamespace(jm=jm, values=values,
                                 prefill=jax.jit(jm.prefill),
                                 decode=jax.jit(jm.decode_step))


def _ref_state(values, jtc):
    """The reference's `make_init_state(model, jtc)` state around given
    parameter values (its body, on the values drawn once)."""
    ptree = jax.tree.map(lambda a: P(jnp.asarray(a), (None,) * a.ndim),
                         values)
    state = {"params": ptree, "opt": j_opt.init_opt_state(ptree, jtc.opt),
             "step": P(jnp.zeros((), jnp.int32), ())}
    if jtc.grad_compression == "int8_ef":
        state["ef_error"] = jax.tree.map(
            lambda p: P(jnp.zeros(p.value.shape, jnp.float32), p.axes),
            ptree, is_leaf=lambda x: isinstance(x, P))
    return split_tree(state)[0]


def _ref_cache_layers(cache, jm):
    """The reference's cache tree ({prefix{i}: {k, v}}, then {seg{si}:
    {pos{pi}: {k, v} [G, ...]}}) as the port's per-layer list."""
    out = [{n: np.asarray(a) for n, a in cache[f"prefix{i}"].items()}
           for i in range(len(jm.prefix))]
    for si, seg in enumerate(jm.segments):
        for g in range(seg.n_groups):
            for pi in range(len(seg.period)):
                leaf = cache[f"seg{si}"][f"pos{pi}"]
                out.append({n: np.asarray(a)[g] for n, a in leaf.items()})
    return out


def _assert_greedy(got_logits, want_logits):
    want = np.asarray(want_logits)[:, -1, :]
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > MARGIN
    np.testing.assert_array_equal(greedy(got_logits).numpy()[sure],
                                  want.argmax(-1)[sure])


PREFILL = (3, 18)   # the launcher's context: 10 ids + 8 prompt tokens


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_reference(variant):
    """A [3, 18] prefill (cap 16 an expert: the last layer of the tiny
    config drops a few assignments, routed as the reference's, since its
    tokens' hidden states align), then 6 decode steps fed the reference's
    greedy ids: logits, every cache leaf, greedy ids."""
    cfg, _ = _cfgs(variant)
    ref = _ref(variant)
    b, s = PREFILL
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    jlogits, jpart = ref.prefill(ref.values, {"tokens": jnp.asarray(tokens)})
    model = lm_params_to_torch(cfg, ref.values, device="cpu")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert [bt.ffn for bt in model.block_types] == (
        ["dense"] * cfg.first_dense_layers + ["moe"] * n_moe)
    drops = []
    logits, part = model.prefill(torch.from_numpy(tokens), drops=drops)
    assert len(drops) == n_moe
    close(logits, jlogits)
    _assert_greedy(logits, jlogits)
    want = _ref_cache_layers(jpart, ref.jm)
    assert len(part) == len(want) == cfg.n_layers
    for got, w in zip(part, want):
        for n in ("k", "v"):
            close(got[n], w[n])
    jcache, _ = split_tree(ref.jm.init_cache(b, s + DECODE_STEPS))
    jcache = j_pad_cache_seq(jcache, jpart)
    cache = _pad_cache_seq(model.init_cache(b, s + DECODE_STEPS), part)
    for t in range(DECODE_STEPS):
        cur = np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None].astype(
            np.int32)
        pos = np.full((b,), s + t, np.int32)
        jlogits, jcache = ref.decode(ref.values, jcache, jnp.asarray(cur),
                                     jnp.asarray(pos), None)
        logits, cache = model.decode_step(cache, torch.from_numpy(cur),
                                          torch.from_numpy(pos))
        close(logits, jlogits)
        _assert_greedy(logits, jlogits)
        for got, w in zip(cache, _ref_cache_layers(jcache, ref.jm)):
            for n in ("k", "v"):
                close(got[n], w[n])


def test_port_init_builds_the_reference_tree():
    """`build_model` builds phi3.5-moe-42b-a6.6b's tiny config from a
    seed: the reference's leaf shapes one to one (the converter accepts
    them), the same parameter count, and the same weights for one seed."""
    cfg, _ = _cfgs("prefix-shared")
    values = _ref("prefix-shared").values
    m1, m2 = (build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(5))
              for _ in range(2))
    got = _leaves(lm_leaves_to_numpy(m1, dict(m1.named_parameters())))
    want = _leaves(values)
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    assert sum(p.numel() for p in m1.parameters()) == sum(
        v.size for v in want.values())
    for (n, p1), (_, p2) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(p1, p2), n
    w_in = m1.layers[1]["ffn"]["w_in"]
    assert abs(float(w_in.detach().std()) * cfg.d_model ** 0.5 - 1.0) < 0.1


# grad_accum and int8_ef are the model's callers' (`train_step.py`),
# held to the reference on the dense models in tests/test_torch_train.py;
# the train-step parity runs without remat in both packages (it halves
# the reference's trace), the port's remat on ≡ off bit for bit being
# test_remat_on_equals_off_bitwise
NO_REMAT = {"remat": False}
# (moments, grad_clip): without the clip, the first step's m is
# (1 − b1) · g, so the float32 case also holds `loss_and_grads`'s
# gradients to the reference's
TRAIN_CASES = [("float32", 0.0), ("int8", 1.0)]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def test_train_steps_match_reference(case):
    """3 `make_train_step` steps from the reference's initial state on the
    variant with a dense prefix layer and a shared expert (int8 moments
    over the last axis of the [E, d, f] expert leaves), without remat
    (`NO_REMAT`): each step's loss, ce and aux (ce + router_aux_weight ·
    aux, aux summed over the MoE blocks), then every leaf of the state.
    Without the clip, `loss_and_grads` on the first batch against the
    reference's first-step m / (1 − b1), leaf by leaf."""
    moments, clip = case
    cfg, jcfg = _cfgs("prefix-shared", **NO_REMAT)
    ref = _ref("prefix-shared")
    kw = dict(lr=1e-3, moment_dtype=moments, grad_clip=clip)
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(**kw))
    tc = TrainConfig(opt=AdamWConfig(**kw))
    jstate = _ref_state(ref.values, jtc)
    values = jax.tree.map(np.asarray, jstate)
    model, state = lm_train_state_to_torch(cfg, tc, values, device="cpu")
    back, want0 = _leaves(lm_train_state_to_numpy(model, state)), _leaves(
        values)
    assert set(back) == set(want0)
    for k in want0:      # the converters are exact inverses
        np.testing.assert_array_equal(back[k], want0[k], err_msg=k)
    jstep = jax.jit(j_ts.make_train_step(j_build_model(jcfg), jtc))
    step = make_train_step(model, tc)
    for i in range(3):
        tokens = np.random.default_rng(10 + i).integers(
            0, cfg.vocab_size, (4, 24)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tokens)}
        if i == 0 and not clip:
            _, _, grads = loss_and_grads(model, state["params"], batch)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, met = step(state, batch)
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL)
        assert float(met["aux"]) > 0.5   # E · Σ f_e p_e ≈ 1 when balanced
        if i == 0 and not clip:
            got = _leaves(lm_leaves_to_numpy(model, grads))
            want = _leaves(jax.tree.map(
                lambda m: np.asarray(m) / (1 - jtc.opt.b1),
                jstate["opt"]["m"]))
            assert set(got) == set(want)
            for k in want:
                close(got[k], want[k], atol=GRAD_TOL * np.abs(want[k]).max(),
                      rtol=0)
    got = lm_train_state_to_numpy(model, state)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"]) == 3
    params = got["params"]
    if moments == "int8":
        params, n_ill, n = _outside_ill_conditioned(params, want)
        assert n_ill <= INT8_PARAM_SHARE * n, (n_ill, n)
    _assert_params_close(params, want["params"], kw["lr"], 3,
                         moments == "int8")
    for which in ("m", "v"):
        _assert_moments_close(got["opt"][which], want["opt"][which], which,
                              quanta=3)


def _outside_ill_conditioned(got_params, want):
    """(the port's parameters with the reference's values where the
    reference's state has m's int8 level nonzero over v's level 0, their
    count, all elements). There the last step divided a quantum of m by a
    √v̂ below v's quantum — a vanishing gradient's, whose ulps differ
    between the packages — and m̂ / (√v̂ + eps) follows those ulps
    without bound (a reference caveat, ROADMAP.md Queue 3)."""
    def by_param(tree):
        return {k.rsplit("/", 1)[0]: v for k, v in _leaves(tree).items()
                if k.endswith("/q")}

    mq, vq = by_param(want["opt"]["m"]), by_param(want["opt"]["v"])
    wp = _leaves(want["params"])
    out, n_ill, n = {}, 0, 0
    for k, g in _leaves(got_params).items():
        ill = ((mq[k] != 0) & (vq[k] == 0))[..., :g.shape[-1]]
        out[k] = np.where(ill, wp[k], g)
        n_ill += int(ill.sum())
        n += g.size
    return _nest(out), n_ill, n


def _nest(flat: dict) -> dict:
    """{"/a/b": leaf} → {"a": {"b": leaf}}."""
    tree = {}
    for k, v in flat.items():
        *path, last = k.strip("/").split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


def test_remat_on_equals_off_bitwise():
    """Checkpointing the prefix block and each group changes no bit of the
    loss, the aux or any gradient."""
    cfg, _ = _cfgs("prefix-shared")
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 24)))}
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        m = build_model(c, device="cpu",
                        generator=torch.Generator().manual_seed(1))
        out.append(loss_and_grads(m, dict(m.named_parameters()), tokens))
    (l1, m1, g1), (l2, m2, g2) = out
    assert torch.equal(l1, l2) and torch.equal(m1["aux"], m2["aux"])
    assert g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_checkpoint_of_an_moe_state_crosses_packages(tmp_path):
    """An int8-moment train state of the tiny MoE with a prefix and a
    shared expert: the reference's checkpoint restores in the port (in the
    reference's layout, then `lm_train_state_to_torch`), and the port's
    state saved in that layout restores in the reference, bit for bit."""
    cfg, _ = _cfgs("prefix-shared")
    tc = TrainConfig(opt=AdamWConfig(moment_dtype="int8"))
    jtc = j_ts.TrainConfig(opt=j_opt.AdamWConfig(moment_dtype="int8"))
    jstate = _ref_state(_ref("prefix-shared").values, jtc)
    want = _leaves(jax.tree.map(np.asarray, jstate))
    j_ckpt.CheckpointManager(str(tmp_path / "j")).save(0, jstate)
    model, state = lm_train_state_to_torch(
        cfg, tc, jax.tree.map(np.asarray, jstate), device="cpu")
    layout = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                          lm_train_state_to_numpy(model, state))
    restored, _ = CheckpointManager(str(tmp_path / "j")).restore(0, layout)
    _, state2 = lm_train_state_to_torch(
        cfg, tc, jax.tree.map(lambda t: t.numpy(), restored), device="cpu")
    got = _leaves(lm_train_state_to_numpy(model, state2))
    CheckpointManager(str(tmp_path / "t")).save(0, layout)
    back, _ = j_ckpt.CheckpointManager(str(tmp_path / "t")).restore(
        0, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate))
    back = _leaves(jax.tree.map(np.asarray, back))
    assert set(got) == set(back) == set(want)
    assert any(k.endswith("/ffn/w_in/q") for k in want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_generate_arch_moe_matches_reference():
    """`launch.serve._generate --arch phi3.5-moe-42b-a6.6b` on the
    reference's weights: the reference launcher's greedy ids
    (`repro/launch/serve.py::_generate`), step for step; without a model
    it builds the tiny MoE from seed 0."""
    cfg, _ = _cfgs()
    ref = _ref("tiny")
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


def test_decode_differs_from_prefill_under_drops_in_both_packages():
    """Reference caveat (ROADMAP.md Queue 3): a row's capacity depends on
    S, so a prefill of [2, 24] at capacity_factor 0.25 (cap 8 for 48
    assignments over 4 experts) drops assignments that a decode step (one
    token, never full) keeps. Decoding token 24 after a prefill of 24
    then differs from a prefill of all 25 tokens — by the same amount in
    both packages."""
    cfg, jcfg = _cfgs(capacity_factor=0.25)
    jm = j_build_model(jcfg)
    prm = _ref("tiny").values       # init_params does not read the cf
    model = lm_params_to_torch(cfg, prm, device="cpu")
    b, s = 2, 24
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    prefill = jax.jit(jm.prefill)
    jfull, _ = prefill(prm, {"tokens": jnp.asarray(toks)})
    _, jpart = prefill(prm, {"tokens": jnp.asarray(toks[:, :s])})
    jcache, _ = split_tree(jm.init_cache(b, s + 1))
    jcache = j_pad_cache_seq(jcache, jpart)
    jdec, _ = jax.jit(jm.decode_step)(prm, jcache, jnp.asarray(toks[:, s:]),
                                      jnp.full((b,), s, jnp.int32), None)
    drops = []
    full, _ = model.prefill(torch.from_numpy(toks), drops=drops)
    _, part = model.prefill(torch.from_numpy(toks[:, :s]))
    cache = _pad_cache_seq(model.init_cache(b, s + 1), part)
    dec, _ = model.decode_step(cache, torch.from_numpy(toks[:, s:]), s)
    close(full, jfull)
    close(dec, jdec)
    assert int(torch.stack(drops).sum()) > 0
    gap = (dec - full).numpy()
    jgap = np.asarray(jdec) - np.asarray(jfull)
    assert np.abs(jgap).max() > 0.05, np.abs(jgap).max()
    close(gap, jgap)
