"""The RG-LRU and mLSTM scan kernels against an earlier build of
``recurrent.cu`` on one card: bits and device time at the served shapes.

    git show <commit>:src/repro_torch/kernels/csrc/recurrent.cu \
        > build/scan_ab/parent.cu
    python3 scripts/chip_scan_ab.py --old build/scan_ab/parent.cu [more.cu
        ...] [--no-check]

Builds each file given by ``--old`` with the port's nvcc flags into
``build/scan_ab/<stem>.so`` (git-ignored; one nvcc each, all started
together) and the current source as the port does, then, at both
models' step and refresh shapes (``chip_smoke.scan_shapes``, bf16
inputs, float32 and bf16 outputs) and at the step in float32:
``chip_smoke.check_scan`` on the current kernel (plain version, float64,
rows alone, split = whole, times, bound; skipped with ``--no-check``),
and for each earlier build whether it gives the current kernel's bits,
the largest difference where it does not, and both timed in turns (old,
new, new, old) on the same inputs, through CUDA graphs as
``chip_smoke.time_ms`` times them. Prints one JSON object a case, then
the card's name and power limit. Needs a card; the extern "C" launch
functions of every file must share their signatures.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import recurrent as krec  # noqa: E402

OUT_DIR = ROOT / "build" / "scan_ab"


def build_old(src: Path) -> ctypes.CDLL:
    """``src`` compiled with the port's flags into OUT_DIR, loaded, its
    launch functions typed as ``recurrent._lib`` types them."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"{src.stem}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    out = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out.rglru_scan_launch.argtypes = [p] * 6 + [i] * 5 + [p]
    out.mlstm_scan_launch.argtypes = [p] * 8 + [i] * 6 + [f, i, i, p]
    out.rglru_scan_launch.restype = out.mlstm_scan_launch.restype = i
    return out


def old_kernel(lib, kind, shape, out_dtype):
    """The old build's launch of ``kind`` on the wrapper's inputs, with
    outputs allocated as the wrapper allocates them."""
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def run(*a):
        x = a[0]
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "rglru":
            gx, u, lam, h0 = a
            B, S, w = u.shape
            hs = torch.empty((B, S, w), dtype=out_dtype, device=u.device)
            hT = torch.empty_like(h0)
            err = lib.rglru_scan_launch(
                gx.data_ptr(), u.data_ptr(), lam.data_ptr(), h0.data_ptr(),
                hs.data_ptr(), hT.data_ptr(), B, S, w, codes[u.dtype],
                codes[out_dtype], stream)
            outs = (hs, hT)
        else:
            proj, C, n, m = a
            _, _, H, dk, dv = shape
            B, S, N = proj.shape
            hs = torch.empty((B, S, H * dv), dtype=out_dtype,
                             device=x.device)
            C1, n1, m1 = (torch.empty_like(t) for t in (C, n, m))
            err = lib.mlstm_scan_launch(
                proj.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                hs.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
                B, S, N, H, dk, dv, float(dk) ** 0.5, codes[proj.dtype],
                codes[out_dtype], stream)
            outs = (hs, C1, n1, m1)
        if err:
            raise RuntimeError(f"old {kind} launch failed: cudaError {err}")
        return outs
    return run


def against(kind, shape, dtype, args, sets, lib):
    """One earlier build against the current kernel on one case: bits
    (float32 and ``dtype`` outputs) and time in turns."""
    bits = {}
    for out_dtype in (torch.float32, dtype):
        new = cs.scan_kernel(kind, shape, out_dtype)(*args)
        old = old_kernel(lib, kind, shape, out_dtype)(*args)
        torch.cuda.synchronize()
        tag = str(out_dtype).split(".")[-1]
        bits[tag] = {
            "equal": all(torch.equal(a, b) for a, b in zip(new, old)),
            "max_abs_diff": max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(new, old))}
    old_fn = old_kernel(lib, kind, shape, dtype)
    new_fn = cs.scan_kernel(kind, shape, dtype)
    turns = [("old", old_fn), ("new", new_fn), ("new", new_fn),
             ("old", old_fn)]
    ms = [(tag, cs.time_ms(fn, sets)) for tag, fn in turns]
    return {"bits": bits, "ms_in_turns": ms,
            "old_ms": (ms[0][1] + ms[3][1]) / 2,
            "new_ms": (ms[1][1] + ms[2][1]) / 2}


def compare(kind, name, shape, dtype, libs, check=True):
    """One case: check_scan on the current kernel, then each earlier
    build against it."""
    rec = {"case": name, "kernel": f"{kind}_scan", "shape": list(shape),
           "dtype": str(dtype).split(".")[-1]}
    if check:
        try:
            out = cs.check_scan(kind, name, shape, dtype)
        except AssertionError as e:      # its record is printed; go on
            out = {"ok": False, "error": str(e)[:400]}
        rec["check"] = {k: v for k, v in out.items()
                        if k in ("ok", "error", "max_rel_err",
                                 "max_rel_err_vs_f64", "max_abs_err",
                                 "rows_alone_equal", "split_equal",
                                 "bf16_out_exact", "kernel_ms", "plain_ms",
                                 "bound_ms", "bound_by")}
    args = cs.scan_inputs(kind, shape, dtype)
    sets = [cs.scan_inputs(kind, shape, dtype, seed=s) for s in range(
        cs.n_copies(cs.nbytes(*args, *cs.scan_kernel(kind, shape, dtype)(
            *args))))]
    rec["old"] = {stem: against(kind, shape, dtype, args, sets, lib)
                  for stem, lib in libs.items()}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, nargs="+", required=True,
                    help="earlier recurrent.cu files to compare against")
    ap.add_argument("--no-check", action="store_true",
                    help="skip check_scan on the current kernel")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    log = build.compile_library("recurrent").with_suffix(".log")
    krec._lib()
    def try_build(src):
        try:
            return build_old(src)
        except RuntimeError as e:        # report it, compare the others
            print(json.dumps({"old": src.stem, "build": str(e)[-600:]}),
                  flush=True)
            return None
    with ThreadPoolExecutor(len(a.old)) as pool:
        libs = {p.stem: lib for p, lib in zip(a.old, pool.map(try_build,
                                                               a.old))
                if lib is not None}
    print(json.dumps({"ptxas": [f for f in cs.ptxas_report(log.read_text())
                                if f["kernel"].startswith(("rglru",
                                                           "mlstm"))]}),
          flush=True)
    ok = True
    for kind, name, shape in cs.scan_shapes():
        if kind == "slstm":
            continue
        cases = [(name, torch.bfloat16)]
        if name.endswith("step"):
            cases.append((name + "_f32", torch.float32))
        for case, dtype in cases:
            rec = compare(kind, case, shape, dtype, libs,
                          check=not a.no_check)
            ok = ok and rec.get("check", {"ok": True})["ok"]
            print(json.dumps(rec), flush=True)
    print(cs.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
