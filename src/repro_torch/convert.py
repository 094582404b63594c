"""Carry state across from the JAX reference package, as numpy arrays.

Every function takes or returns plain numpy arrays (a caller holding JAX
objects passes `np.asarray(leaf)` for each leaf), so this module needs
neither `jax` nor `repro`. uint32 arrays — the visited bitset, label
words, program masks — are reinterpreted as int32 with
`ndarray.view(np.int32)` on the way in and back with `view(np.uint32)` on
the way out: the bits never change.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.engine import SearchEngine
from repro_torch.core.estimator import CostEstimator
from repro_torch.core.gbdt import GBDTModel
from repro_torch.core.planner import Planner
from repro_torch.core.state import SearchState
from repro_torch.device import resolve_device
from repro_torch.filters.compile import FilterProgram, program_to
from repro_torch.quant.codecs import Int8Index, Int8Prep, PQIndex, PQPrep

_STATE_DTYPES = {
    "cand_dist": torch.float32, "cand_idx": torch.int32,
    "cand_exp": torch.bool, "cand_valid": torch.bool,
    "res_dist": torch.float32, "res_idx": torch.int32,
    "visited": torch.int32, "cnt": torch.int32, "n_inspected": torch.int32,
    "n_valid_visited": torch.int32, "n_clause_valid": torch.int32,
    "n_pop_valid": torch.int32, "q_err_sum": torch.float32,
    "hops": torch.int32, "active": torch.bool, "d_start": torch.float32,
    "conv_cnt": torch.int32, "res_full_cnt": torch.int32,
}


def _as_int32_bits(a: np.ndarray) -> np.ndarray:
    a = np.array(a, order="C")  # a writable copy (JAX arrays are read-only)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def state_to_torch(leaves: Sequence[np.ndarray], device=None) -> SearchState:
    """The 18 leaves of a reference SearchState, in field order → torch."""
    dev = resolve_device(device)
    if len(leaves) != len(SearchState._fields):
        raise ValueError(f"expected {len(SearchState._fields)} leaves, got "
                         f"{len(leaves)}")
    return SearchState(*(
        torch.from_numpy(_as_int32_bits(np.asarray(a))).to(dev, dt)
        for a, dt in zip(leaves, (_STATE_DTYPES[f]
                                  for f in SearchState._fields))))


def state_to_numpy(state: SearchState) -> tuple[np.ndarray, ...]:
    """A port SearchState → 18 numpy leaves in the reference's dtypes
    (visited back as uint32)."""
    out = []
    for name, t in zip(SearchState._fields, state):
        a = t.detach().cpu().numpy()
        out.append(a.view(np.uint32) if name == "visited" else a)
    return tuple(out)


def program_to_torch(leaves: Sequence[np.ndarray], device=None,
                     ) -> FilterProgram:
    """The 9 leaves of a reference FilterProgram (masks uint32) → torch."""
    return program_to(FilterProgram(*leaves), resolve_device(device))


def _named_to_torch(kinds, obj, device):
    """A reference NamedTuple of arrays → the port's type with the same
    field names (the first of `kinds` whose fields match)."""
    fields = tuple(obj._fields)
    for cls in kinds:
        if cls._fields == fields:
            dev = resolve_device(device)
            return cls(*(torch.from_numpy(np.array(a, order="C")).to(dev)
                         for a in obj))
    raise TypeError(f"no port counterpart with fields {fields}")


def quant_to_torch(index, device=None):
    """A reference Int8Index or PQIndex (leaves as numpy or JAX arrays) →
    the port's, with the same dtypes (codes int8 / uint8)."""
    return _named_to_torch((Int8Index, PQIndex), index, device)


def qprep_to_torch(prep, device=None):
    """A reference Int8Prep or PQPrep → the port's."""
    return _named_to_torch((Int8Prep, PQPrep), prep, device)


def quant_to_numpy(obj) -> tuple[np.ndarray, ...]:
    """A port quant index or prep → its leaves as numpy arrays, in field
    order and dtype."""
    return tuple(t.detach().cpu().numpy() for t in obj)


def engine_from_arrays(vectors: np.ndarray, labels_packed: np.ndarray,
                       values: np.ndarray, neighbors: np.ndarray,
                       entry_point: int, backend: str | None = None,
                       device=None, precision: str = "float32",
                       quant=None) -> SearchEngine:
    """Dataset arrays (vectors [N,d], labels [N,W] uint32, values [N,V])
    and graph arrays (neighbors [N,R], entry point) → SearchEngine; a
    quantized engine takes the reference's quant index as `quant`."""
    dev = resolve_device(device)
    values = np.asarray(values, np.float32)
    if values.ndim == 1:
        values = values[:, None]
    return SearchEngine(
        base_vectors=torch.from_numpy(
            np.ascontiguousarray(vectors, np.float32)).to(dev),
        label_attrs=torch.from_numpy(_as_int32_bits(labels_packed)).to(
            dev, torch.int32),
        value_attrs=torch.from_numpy(np.ascontiguousarray(values)).to(dev),
        neighbors=torch.from_numpy(
            np.ascontiguousarray(neighbors, np.int32)).to(dev),
        entry_point=int(entry_point),
        backend=backend,
        precision=precision,
        quant=None if quant is None else quant_to_torch(quant, dev),
    )


def gbdt_from_arrays(feat: np.ndarray, thresh: np.ndarray, leaf: np.ndarray,
                     base: float, depth: int,
                     importances: np.ndarray | None = None) -> GBDTModel:
    """A reference GBDTModel's arrays → the port's GBDTModel."""
    feat = np.asarray(feat, np.int32)
    return GBDTModel(
        feat=feat, thresh=np.asarray(thresh, np.float32),
        leaf=np.asarray(leaf, np.float32), base=float(base), depth=int(depth),
        importances=(np.zeros(int(feat.max(initial=0)) + 1)
                     if importances is None else np.asarray(importances)))


def estimator_to_torch(est) -> CostEstimator:
    """A reference CostEstimator (its GBDTModel's numpy arrays) → the
    port's."""
    m = est.model
    return CostEstimator(
        gbdt_from_arrays(m.feat, m.thresh, m.leaf, m.base, m.depth,
                         m.importances),
        log_target=bool(est.log_target))


def planner_to_torch(planner) -> Planner:
    """A reference Planner → the port's: its three GBDT heads (traverse,
    widen, static), the scan cost rate and the scan floor."""
    return Planner(traverse=estimator_to_torch(planner.traverse),
                   widen=estimator_to_torch(planner.widen),
                   static=estimator_to_torch(planner.static),
                   scan_dist_cost=float(planner.scan_dist_cost),
                   scan_floor=int(planner.scan_floor))


def _part_names(mod, prefix: str) -> dict:
    """{key: port parameter name} of a block part, nested where the part
    nests (an MoE's "shared" MLP); {} for a non-parametric norm."""
    return {n: (_part_names(v, f"{prefix}.{n}") if isinstance(v, nn.Module)
                else f"{prefix}.{n}") for n, v in mod.items()}


def _zip_names(trees: list, fn):
    """One tree of the shape the `trees` (names trees of equal shape)
    share, fn([their names]) at each leaf."""
    if isinstance(trees[0], dict):
        return {k: _zip_names([t[k] for t in trees], fn) for k in trees[0]}
    return fn(trees)


def _lm_tree(model, leaf, stack):
    """The reference's parameter tree of `model`: leaf(port parameter
    name) at each leaf. A `prefix{i}` block is layer i (unstacked, as the
    reference unrolls its prefix); a `seg{si}/pos{pi}` leaf, which carries
    a leading n_groups axis in the reference (it scans over groups), is
    stack([leaf of layer g·len(period) + pi for each group g]), counted
    after the prefix. A block holds the parts its type draws ({norm1,
    mixer} of an SSM block, {norm1, norm2, ffn} of a shared_attn
    position, a cross block's norm_cross and cross besides its attn). The
    hybrid's `shared` block and the MTP head's `mtp_proj`, `mtp_block` and
    `mtp_norm` are top-level and unstacked, as the reference draws them;
    the enc-dec's `enc_blocks` is stack([leaf of encoder layer i for each
    i]) and its `enc_norm` top-level. Empty norm dicts (non-parametric LN)
    stay as {}."""
    tree = {"embed": leaf("embed"),
            "final_norm": {n: leaf(f"final_norm.{n}")
                           for n in model.final_norm}}
    if not model.cfg.tie_embeddings:
        tree["head"] = leaf("head")

    def block(mod, prefix: str) -> dict:
        return {part: _part_names(mod[part], f"{prefix}.{part}")
                for part in mod}

    def one(mod, prefix: str) -> dict:
        return _zip_names([block(mod, prefix)], lambda ns: leaf(ns[0]))

    if model.shared is not None:
        tree["shared"] = one(model.shared, "shared")
    for i in range(len(model.prefix)):
        tree[f"prefix{i}"] = one(model.layers[i], f"layers.{i}")
    li = len(model.prefix)
    for si, seg in enumerate(model.segments):
        per = len(seg.period)
        tree[f"seg{si}"] = {
            f"pos{pi}": _zip_names(
                [block(model.layers[j], f"layers.{j}")
                 for j in range(li + pi, li + seg.n_groups * per, per)],
                lambda ns: stack([leaf(n) for n in ns]))
            for pi in range(per)}
        li += seg.n_groups * per
    if hasattr(model, "enc_layers"):
        tree["enc_blocks"] = _zip_names(
            [block(m, f"enc_layers.{i}")
             for i, m in enumerate(model.enc_layers)],
            lambda ns: stack([leaf(n) for n in ns]))
        tree["enc_norm"] = {n: leaf(f"enc_norm.{n}") for n in model.enc_norm}
    if model.cfg.mtp:
        tree["mtp_proj"] = leaf("mtp_proj")
        tree["mtp_block"] = one(model.mtp_block, "mtp_block")
        tree["mtp_norm"] = {n: leaf(f"mtp_norm.{n}")
                            for n in model.mtp_norm}
    return tree


def _lm_names(model) -> dict:
    """`_lm_tree` with port parameter names at its leaves (a list of
    names, one a group, for a stacked leaf)."""
    return _lm_tree(model, lambda n: n, list)


def _stack(xs):
    if isinstance(xs[0], dict):
        return {k: _stack([x[k] for x in xs]) for k in xs[0]}
    return np.stack(xs)


def _walk(names, values, fn, where: str = "") -> None:
    """fn(port name, the reference's leaf) for every leaf of the names
    tree, a stacked leaf split by group; raises ValueError where the
    reference's tree holds other keys or group counts. A leaf may be a
    dict ({"q", "scale"} of an int8 moment)."""
    if isinstance(names, dict):
        if not isinstance(values, dict) or set(names) != set(values):
            got = sorted(values) if isinstance(values, dict) else values
            raise ValueError(f"{where or 'tree'}: expected keys "
                             f"{sorted(names)}, got {got}")
        for k in names:
            _walk(names[k], values[k], fn, f"{where}/{k}")
    elif isinstance(names, list):
        for g, n in enumerate(names):
            fn(n, _take(values, g, len(names), where))
    else:
        fn(names, values)


def _take(v, g: int, n_groups: int, where: str):
    if isinstance(v, dict):
        return {k: _take(x, g, n_groups, where) for k, x in v.items()}
    a = np.asarray(v)
    if a.shape[0] != n_groups:
        raise ValueError(f"{where}: {a.shape[0]} groups in the tree, "
                         f"{n_groups} in the model")
    return a[g]


def _copy_into(dst: torch.Tensor, a, name: str) -> None:
    t = torch.from_numpy(np.array(a, order="C"))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(dst.shape)}")
    dst.data.copy_(t.to(dst.device, dst.dtype))


def lm_params_to_torch(cfg, values, device=None):
    """The reference's LM parameters → a port `DecoderLM` (an `EncDecLM`
    for the enc-dec family) that computes the same thing.

    `values` is `split_tree(model.init_params(key))[0]` of the reference
    as a nested dict of numpy arrays; `cfg` the port's `ArchConfig` of the
    same architecture. Each `seg{si}/pos{pi}` leaf carries a leading
    n_groups axis (the reference scans over groups); group g's slice
    becomes layer g·len(period) + pi; `enc_blocks`' slice i, encoder layer
    i. `embed` stays tied to the head where `cfg.tie_embeddings` is set."""
    from repro_torch.models.zoo import model_class

    model = model_class(cfg)(cfg, device=device)
    params = dict(model.named_parameters())
    _walk(_lm_names(model), values,
          lambda n, a: _copy_into(params[n], a, n))
    return model


def lm_train_state_to_torch(cfg, tc, values, device=None):
    """The reference's train state → (a port `DecoderLM`, its train state
    from `train.make_init_state(model, tc)`) holding the same values.

    `values` is `split_tree(make_init_state(model, tc)(key))[0]` of the
    reference, or a state after steps, as a nested dict of numpy arrays:
    "params", "opt" ({"m", "v", "count"}; under int8 moments each moment
    leaf is {"q", "scale"}), "step" and, under "int8_ef", "ef_error".
    Every tree of parameter shape is unstacked as `lm_params_to_torch`
    unstacks the parameters."""
    from repro_torch.train.train_step import make_init_state

    model = lm_params_to_torch(cfg, values["params"], device)
    state = make_init_state(model, tc)
    if set(values) != set(state):
        raise ValueError(f"state keys {sorted(values)}, expected "
                         f"{sorted(state)}")
    names = _lm_names(model)

    def load(dst: dict):
        def fn(n, a):
            if isinstance(dst[n], dict):
                for k in dst[n]:
                    _copy_into(dst[n][k], a[k], f"{n}/{k}")
            else:
                _copy_into(dst[n], a, n)
        return fn

    for which in ("m", "v"):
        _walk(names, values["opt"][which], load(state["opt"][which]))
    if "ef_error" in state:
        _walk(names, values["ef_error"], load(state["ef_error"]))
    state["opt"]["count"].fill_(int(np.asarray(values["opt"]["count"])))
    state["step"].fill_(int(np.asarray(values["step"])))
    return model, state


def lm_leaves_to_numpy(model, leaves: dict) -> dict:
    """{port parameter name: tensor, or {"q", "scale"} of an int8 moment}
    (parameters, gradients, moments) → the reference's parameter tree of
    numpy arrays, the per-layer leaves stacked into `seg{si}/pos{pi}`
    leaves over groups (the encoder's into `enc_blocks`), bfloat16 as
    float32."""
    def leaf(n):
        v = leaves[n]
        if isinstance(v, dict):
            return {k: _numpy(x) for k, x in v.items()}
        return _numpy(v)

    return _lm_tree(model, leaf, _stack)


def lm_train_state_to_numpy(model, state) -> dict:
    """A port train state → the reference's layout as nested numpy arrays
    (the inverse of `lm_train_state_to_torch`)."""
    opt = state["opt"]
    out = {"params": lm_leaves_to_numpy(model, state["params"]),
           "opt": {"m": lm_leaves_to_numpy(model, opt["m"]),
                   "v": lm_leaves_to_numpy(model, opt["v"]),
                   "count": _numpy(opt["count"])},
           "step": _numpy(state["step"])}
    if "ef_error" in state:
        out["ef_error"] = lm_leaves_to_numpy(model, state["ef_error"])
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()
