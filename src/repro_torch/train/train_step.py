"""train_step: loss → gradients → (compressed) AdamW update.

Counterpart of `repro/train/train_step.py`:
  - gradient accumulation: the batch splits into `grad_accum`
    microbatches, whose gradients are summed in float32 and divided by
    `grad_accum`; the loss and metrics returned are the last
    microbatch's, as the reference's scan carries them;
  - int8 error-feedback gradient compression: x = g + e, g' =
    dequantize(quantize(x)), e' = x − g' (the reference models the
    compressed all-reduce's wire format; the residual is carried in the
    state's `ef_error`, so no signal is lost);
  - the optimizer's moments in float32, bfloat16 or int8 (optimizer.py).

A train state is a dict of tensors: "params" ({name: parameter} — the
model's own `nn.Parameter`s, in `named_parameters` order), "opt"
(`init_opt_state`), "step" (int32 0-d) and, under "int8_ef",
"ef_error" ({name: float32}). A step updates it in place and returns it,
with its metrics as 0-d tensors on the model's device: nothing waits for
the card. A state restored from a checkpoint holds new tensors; copy it
into the live state with `load_state_` before stepping.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         dequantize, init_opt_state, quantize)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    grad_compression: str = "none"   # none | int8_ef


def make_init_state(model, tc: TrainConfig) -> dict:
    """The train state of `model` as it stands: its parameters, zero
    moments, step 0 and, under "int8_ef", a zero error-feedback buffer."""
    if tc.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"grad_compression {tc.grad_compression!r}")
    params = dict(model.named_parameters())
    step = next(iter(params.values())).new_zeros((), dtype=torch.int32)
    state = {"params": params, "opt": init_opt_state(params, tc.opt),
             "step": step}
    if tc.grad_compression == "int8_ef":
        state["ef_error"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()}
    return state


def loss_and_grads(model, params: dict, batch: dict, grad_accum: int = 1):
    """(loss, metrics, {name: gradient}) of `model.loss` over `batch`,
    taken with respect to `params` (the model's parameters). With
    grad_accum > 1 every leaf of the batch (the tokens [B, S], a memory
    "enc" [B, Se, d]) splits along its batch axis, leaf.reshape(grad_accum,
    B / grad_accum, ...), the gradients are the float32 mean over the
    microbatches, and the loss and metrics the last microbatch's. A
    parameter the loss never reads (zamba2's shared_attn positions' own
    norm2 and FFN) gets a zero gradient, as `jax.grad` gives it."""
    names, leaves = list(params), list(params.values())
    if grad_accum <= 1:
        loss, metrics = model.loss(batch)
        grads = _grad(loss, leaves)
        return loss.detach(), _detach(metrics), dict(zip(names, grads))
    b = batch["tokens"].shape[0]
    if b % grad_accum or any(v.shape[0] != b for v in batch.values()):
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        raise ValueError(f"batch {shapes} does not split into {grad_accum} "
                         "microbatches")
    split = {k: v.reshape(grad_accum, b // grad_accum, *v.shape[1:])
             for k, v in batch.items()}
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    for i in range(grad_accum):
        loss, metrics = model.loss({k: v[i] for k, v in split.items()})
        for a, g in zip(acc, _grad(loss, leaves)):
            a.add_(g.to(torch.float32))
    grads = {k: a.div_(grad_accum) for k, a in zip(names, acc)}
    return loss.detach(), _detach(metrics), grads


def _grad(loss, leaves) -> list:
    """d loss / d leaf for every leaf, zeros where the loss reads none."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _detach(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(model, tc: TrainConfig):
    """step(state, batch) -> (state, metrics): one optimizer step over
    batch {"tokens": [B, S]} (and a cross model's memory "enc" [B, Se,
    d]), the state updated in place; metrics, 0-d
    tensors on the model's device, are `model.loss`'s ({"ce", "aux"},
    and "mtp_ce" with an MTP head) and "loss"."""

    def step(state: dict, batch: dict):
        params = state["params"]
        loss, metrics, grads = loss_and_grads(model, params, batch,
                                              tc.grad_accum)
        if tc.grad_compression == "int8_ef":
            with torch.no_grad():
                for k, g in grads.items():
                    e = state["ef_error"][k]
                    x = g.to(torch.float32) + e
                    deq = dequantize(quantize(x), x.shape)
                    grads[k] = deq
                    e.copy_(x - deq)
        adamw_update(params, grads, state["opt"], tc.opt)
        state["step"].add_(1)
        return state, {**metrics, "loss": loss}

    return step


@torch.no_grad()
def load_state_(state: dict, values: dict) -> dict:
    """Copy a tree of tensors (a restored checkpoint) into the live
    `state`, leaf by leaf, in place; the trees must hold the same keys
    and shapes. Returns `state`."""
    if isinstance(state, dict):
        if not isinstance(values, dict) or set(state) != set(values):
            got = sorted(values) if isinstance(values, dict) else values
            raise ValueError(f"keys {sorted(state)} vs {got}")
        for k in state:
            load_state_(state[k], values[k])
        return state
    if tuple(state.shape) != tuple(values.shape):
        raise ValueError(f"shape {tuple(values.shape)}, expected "
                         f"{tuple(state.shape)}")
    state.copy_(values)
    return state
