"""Training launcher: seeded token batches → train step → checkpoints
and restart → straggler monitor, on one device.

Counterpart of `repro/launch/train.py` without the mesh (which comes
with ROADMAP.md Queue 1, items 3 and 5h). It trains the `tiny()` config
of `--arch` (any LM of the zoo: olmo-1b, phi3.5-moe-42b-a6.6b,
deepseek-v3-671b, mamba2-2.7b, zamba2-2.7b, llama-3.2-vision-90b,
whisper-small, ...) unless `--full-config` is given, on the CUDA device,
and raises when there is none unless `--device cpu` is given. Each step
draws its tokens and, for a model that cross-attends (vlm, encdec), its
stub memory 0.02 · N(0, 1) [batch, vision_seq or encoder_seq, d] right
after them from the same generator, as the reference's launcher does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 50 --batch 8 --seq 64 [--full-config] [--resume]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmo-1b",
                    help="a config of the zoo")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="the architecture at its published size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.fault_tolerance import StepMonitor
    from repro_torch.models import build_model
    from repro_torch.models.transformer import cross_len
    from repro_torch.train import (AdamWConfig, CheckpointManager,
                                   TrainConfig, load_state_, make_init_state,
                                   make_train_step)

    cfg = get_arch(args.arch)
    if not args.full_config:
        cfg = cfg.tiny()
    model = build_model(cfg, device=args.device)
    dev = model.device
    tc = TrainConfig(opt=AdamWConfig(lr=args.lr), grad_accum=args.grad_accum)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {dev} ({kind}), {cfg.name}"
          f"{'' if args.full_config else ' tiny'}: "
          f"{sum(p.numel() for p in model.parameters())} parameters")

    state = make_init_state(model, tc)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        restored, manifest = mgr.restore_latest(state)
        load_state_(state, restored)
        start = manifest["step"]
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, tc)
    rng = np.random.default_rng(0)
    mon = StepMonitor()
    t0 = time.time()
    for i in range(start, args.steps):
        tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev)}
        if model.has_cross:
            enc = 0.02 * rng.standard_normal(
                (args.batch, cross_len(cfg), cfg.d_model))
            batch["enc"] = torch.from_numpy(enc).to(dev, cfg.compute_dtype)
        mon.start()
        state, metrics = step_fn(state, batch)
        ev = mon.stop()
        if ev:
            print(f"[straggler] step {ev.step}: {ev.duration:.2f}s "
                  f"(median {ev.median:.2f}s) — rollback candidates ready")
        if (i + 1) % 10 == 0:
            print(f"step {i+1:4d} loss={float(metrics['loss']):.4f} "
                  f"({(time.time()-t0)/(i+1-start):.2f}s/step)")
        if (i + 1) % args.ckpt_every == 0:
            path = mgr.save(i + 1, state)
            print(f"checkpoint -> {path}")
    print("done")


if __name__ == "__main__":
    main()
