"""Training launcher of the port (``repro.launch.train``'s counterpart).

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-100m \\
        --steps 300 --batch 16 --seq-len 76 \\
        --ckpt results/torch/ckpt/tiny100m
On the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tiny --steps 40 --ckpt /tmp/tiny
``--arch`` takes every registered config (the recurrent ones train
through their plain scans under autograd, e.g. ``--arch
xlstm-350m-smoke``).

``--ckpt`` writes the JAX package's checkpoint format (``.npz`` +
``.json``), which ``python -m repro_torch.launch.serve --ckpt`` and the
JAX package's ``checkpoint.restore`` both read. ``--dtype`` is the
compute dtype; the weights and the optimizer's moments stay float32, as
every config's ``param_dtype`` is.

Production-shape check of the train step (any registered arch; one
rank's count on shape-only tensors, on the CPU, touching no card; see
``launch/dryrun.py`` for the full matrix), written to
results/torch/dryrun/:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \
        --lower-only
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="compute dtype (default: the config's)")
    ap.add_argument("--lower-only", action="store_true",
                    help="the train step's production-shape dry run "
                    "(launch.dryrun, train_4k on the production mesh)")
    args = ap.parse_args(argv)

    if args.lower_only:
        from repro_torch.launch.dryrun import run_one
        return run_one(args.arch, "train_4k", False)

    from repro_torch.device import resolve_device
    from repro_torch.models import get_config
    from repro_torch.training.train import TrainConfig, train
    device = resolve_device(args.device)
    over = {"dtype": args.dtype} if args.dtype else {}
    cfg = get_config(args.arch, **over)
    params, hist = train(cfg, TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq_len,
        checkpoint_path=args.ckpt or None), device=device)
    print(f"done: loss {hist[-1]['loss']:.4f} "
          f"masked_acc {hist[-1]['masked_acc']:.3f}")
    return params, hist


if __name__ == "__main__":
    main()
