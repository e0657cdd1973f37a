"""The recurrent families served through two checkouts of the repository
in turns on one card: a pass and block 0 of each.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/chip_recurrent_ab.py build/parent .

Runs ``chip_smoke.serve_family`` (full width and depth, bf16 random
weights from seed 0, streaming, 2 prompts of 128 bytes, gen_len 64) for
recurrentgemma-9b and xlstm-350m in each checkout, in the order A, B, B,
A, one process a model and checkout, each building that checkout's
kernels into its own ``build/``. Prints one JSON object a run (the
checkout, the model, the time a pass, block 0's wall time and device
idle share, the scans' launches) and then the card's name and power
limit. Needs a card; both checkouts need ``chip_smoke.serve_family``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ARCHS = ("recurrentgemma-9b", "xlstm-350m")
RUN = ("import sys, torch, chip_smoke as cs; "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "cs.serve_family(sys.argv[1], 'cuda', 'recurrent')")


def serve(tree: Path, arch: str) -> dict:
    """``serve_family(arch)`` in a process of its own from ``tree``: its
    record, cut to the numbers compared."""
    out = subprocess.run([sys.executable, "-c", RUN, arch], cwd=tree,
                         capture_output=True, text=True)
    rec = None
    for ln in out.stdout.splitlines():
        if ln.startswith("{") and '"arch"' in ln:
            rec = json.loads(ln)
    if out.returncode or rec is None:
        raise RuntimeError(f"{tree} {arch}: exit {out.returncode}\n"
                           f"{out.stderr[-2000:]}")
    block = rec.get("profile_block0", {})
    return {"tree": str(tree), "arch": arch,
            "step_ms": rec["decode"]["step_ms"],
            "block0_wall_ms": block.get("wall_us", 0.0) / 1e3,
            "block0_idle_share": block.get("device_idle_share"),
            "launches": {k: v for k, v in rec["decode"]["launches"].items()
                         if k.endswith("_scan")},
            "ok": rec["ok"]}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (Path(p).resolve() for p in args)
    for tree in (a, b, b, a):
        for arch in ARCHS:
            print(json.dumps(serve(tree, arch)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
