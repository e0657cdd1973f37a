"""Training launcher of the port (``repro.launch.train``'s counterpart).

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-100m \\
        --steps 300 --batch 16 --seq-len 76 \\
        --ckpt results/torch/ckpt/tiny100m
On the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tiny --steps 40 --ckpt /tmp/tiny

``--ckpt`` writes the JAX package's checkpoint format (``.npz`` +
``.json``), which ``python -m repro_torch.launch.serve --ckpt`` and the
JAX package's ``checkpoint.restore`` both read. ``--dtype`` is the
compute dtype; the weights and the optimizer's moments stay float32, as
every config's ``param_dtype`` is. The production-shape lowering check
(``--lower-only``) is the dry run, ROADMAP A14.
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
                    help="production-shape lowering check (ROADMAP A14: "
                    "not ported, raises)")
    args = ap.parse_args(argv)

    if args.lower_only:
        raise NotImplementedError(
            "--lower-only (the dry run's lowering specs, launch/steps.py) "
            "is ROADMAP A14")

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
