"""Training entry point of the port: the trainer with checkpointing,
auto-resume and the immune MoE balancing, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 100 --workdir /tmp/run1 [--device cpu]

``--smoke`` trains the reduced config; without it the full config is built
(on the card). Runs on ``cuda`` unless ``--device cpu`` is given. Re-running
with the same ``--workdir`` resumes from its newest checkpoint. The host
mesh is declared (``launch.mesh.make_host_mesh``); the parameters stay plain
tensors, so every constraint is a no-op, as in the JAX launcher.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is visible "
                 "(pass --device cpu)")

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    layers.set_mesh_axes(make_host_mesh(device=args.device))
    tcfg = TrainConfig(learning_rate=args.lr,
                       warmup_steps=max(args.steps // 20, 5),
                       decay_steps=args.steps, schedule=args.schedule)
    tr = Trainer(
        cfg=cfg, tcfg=tcfg, workdir=args.workdir, batch=args.batch,
        seq=args.seq, ckpt_every=args.ckpt_every, device=args.device,
        on_metrics=lambda m: print(
            f"step {m['step']:5d}  loss {m['loss']:.4f}  "
            f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}  "
            f"load_cv {m['load_cv']:.3f}  {m['sec_per_step']:.2f}s/step",
            flush=True))
    state = tr.train(args.steps)
    print(f"done; checkpoints in {args.workdir}")
    return tr, state


if __name__ == "__main__":
    main()
