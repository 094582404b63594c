"""Training example on the PyTorch/CUDA port: a tiny LM for a few hundred
steps with the full training path — AdamW (optionally int8 moments),
gradient accumulation, checkpoint/restart and straggler monitoring.

Everything runs on `--device` (default: the CUDA device, which must
exist; `--device cpu` runs on the CPU).

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps 200] \\
        [--arch olmo-1b] [--device cpu] [--resume]

`--arch` takes any dense or MoE config, deepseek-v3-671b (MLA and the
MTP head, whose cross-entropy is printed beside the backbone's), and the
SSM and hybrid configs (mamba2-2.7b, zamba2-2.7b) too. The VLM and
the enc-dec (llama-3.2-vision-90b, whisper-small) raise ValueError: these
batches carry tokens alone, and those models cross-attend to a memory
(`python -m repro_torch.launch.train --arch whisper-small` draws one).
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed.fault_tolerance import StepMonitor
from repro_torch.models import build_model
from repro_torch.models.zoo import refuse_memory
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainConfig,
                               load_state_, make_init_state, make_train_step)


def synthetic_batches(vocab, batch, seq, seed=0):
    """Markov-chain tokens — learnable structure so loss visibly drops
    (numpy int32 [batch, seq], the reference example's draws)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    cum = np.cumsum(trans, axis=1)
    while True:
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        u = rng.random((batch, seq))
        for t in range(1, seq):
            toks[:, t] = np.array(
                [np.searchsorted(cum[toks[b, t - 1]], u[b, t])
                 for b in range(batch)])
        yield np.clip(toks, 0, vocab - 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).tiny()
    refuse_memory(cfg, "this example")
    model = build_model(cfg, device=args.device)
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, weight_decay=0.01),
                     grad_accum=2)
    state = make_init_state(model, tc)
    step_fn = make_train_step(model, tc)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        restored, manifest = mgr.restore_latest(state)
        load_state_(state, restored)
        start = manifest["step"]
        print(f"resumed from step {start}")

    data = synthetic_batches(cfg.vocab_size, batch=8, seq=64)
    mon = StepMonitor()
    t0 = time.time()
    metrics = None
    for i in range(start, args.steps):
        batch = {"tokens": torch.from_numpy(next(data)).to(model.device)}
        mon.start()
        state, metrics = step_fn(state, batch)
        ev = mon.stop()
        if ev:
            print(f"  [straggler] step {ev.step}: {ev.duration:.2f}s "
                  f"vs median {ev.median:.2f}s")
        if (i + 1) % 25 == 0:
            mtp = (f"mtp_ce={float(metrics['mtp_ce']):.3f} "
                   if "mtp_ce" in metrics else "")
            print(f"step {i+1:4d} loss={float(metrics['loss']):.3f} "
                  f"ce={float(metrics['ce']):.3f} {mtp}"
                  f"({(time.time()-t0)/(i+1-start):.2f}s/step)")
        if (i + 1) % 100 == 0:
            mgr.save(i + 1, state)
            print(f"  checkpointed step {i+1} -> {args.ckpt_dir}")
    if metrics is None:
        print(f"nothing to do: the checkpoint is at step {start}")
        return
    print(f"done. final ce={float(metrics['ce']):.3f} "
          f"(random ≈ {np.log(cfg.vocab_size):.3f})")


if __name__ == "__main__":
    main()
