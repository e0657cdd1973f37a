"""Dry run: count one rank's step of every (architecture x input shape)
on the production meshes, on shape-only tensors, and derive its
roofline on the H100: the PyTorch counterpart of ``repro.launch.dryrun``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape decode_32k [--multi-pod] [--variant streaming|frozen|baseline]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records land in results/torch/dryrun/<arch>__<shape>__<mesh>[__<variant>]
.json, with the reference's keys: per-device FLOPs, bytes, memory
(argument, output, temporary), collectives by kind and the roofline
terms at H100 rates (``kernels.cost``).

What takes the place of XLA's compile: ``launch.steps`` builds one
rank's step on fake tensors on the explicit ``steps.DEVICE`` ("cpu"),
and ``count`` runs it under a dispatch mode (``Meter``) that counts with
``torch.utils.flop_counter.FlopCounterMode``'s formulas. Nothing is
allocated, nothing reaches a kernel library or the card, and the route
is the same on a machine with CUDA as without. The count:

- a call of a kernel wrapper of ``kernels.ops`` is one op: its own
  operations and bytes (``kernels.cost``, the count behind
  ``chip_smoke.py``'s bound column), none of its plain body's;
- every other op's FLOPs are FlopCounterMode's formula's for it
  (products and attention-like ops; no elementwise op), and its bytes its
  inputs plus outputs: an unfused count (no op's result stays on chip),
  whose time is ``memory_s``, an upper estimate; ``memory_floor_s`` is
  the lower bound beside it (the kernels' own bytes, or the arguments
  read once and the outputs written once, whichever is larger);
- temporary bytes are the peak of the step's live allocations that are
  not its outputs, argument bytes the shards it is called with, output
  bytes its results (with XLA's 8-byte index a leaf of a tuple result,
  so that the two records' outputs read alike); the serving layouts the
  decoder builds once (a tied head's copy, the recurrent mixers'
  concatenations) are counted apart (``serving_layout_bytes``);
- collectives are what the port issues for the counted rank
  (``Mesh.for_count``: every line a counting group of its true size),
  by kind: count and result bytes. The row-parallel products' chain
  (``models.layers.row_parallel``: a model line's ranks multiply one
  after another) is a roofline term of its own, ``chain_s``: the line's
  size times this rank's chained products' time.

The port's layers are a list, not a scan: one count covers every layer,
so ``run_corrected`` writes the same count under results/torch/roofline/
(its ``method`` says so) with no second pass to difference.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost

OUT_DIR = "results/torch/dryrun"
ROOFLINE_DIR = "results/torch/roofline"
# the reference's production set (``repro.configs.ASSIGNED``)
ASSIGNED = [
    "xlstm-350m", "musicgen-medium", "recurrentgemma-9b", "minitron-4b",
    "llava-next-34b", "olmoe-1b-7b", "kimi-k2-1t-a32b", "gemma2-27b",
    "phi4-mini-3.8b", "qwen3-32b",
]
# XLA's output size counts its result tuple's index table: a pointer a leaf
TUPLE_INDEX_BYTES = 8
# ops that move no bytes
_NO_TRAFFIC = ("empty", "new_empty", "empty_like", "empty_strided",
               "detach", "lift_fresh", "alias")
NOTES = {
    "cpu_promotion_bytes": "no counterpart: XLA:CPU's bf16->f32 buffers; "
                           "the count runs nothing on a CPU",
    "temp_bytes_tpu_estimate": "no counterpart (a TPU estimate)",
    "hbm_bytes": "unfused: each op's inputs read and outputs written; a "
                 "kernel wrapper's call one op of its own bytes",
    "memory_floor_s": "a lower bound: max(the kernels' own bytes, the "
                      "arguments read once + new outputs written once) "
                      "over the HBM rate; memory_s (hbm_bytes) is the "
                      "unfused upper estimate",
    "flops": "FlopCounterMode's products and attention-like ops, and each "
             "kernel's own count; no elementwise op",
}


def _storage(t):
    return t.untyped_storage()


def _flat(x, out=None):
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, dicts of kwargs)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Meter(TorchDispatchMode):
    """The count's dispatch mode, above the fake tensors' mode: FLOPs by
    dtype (``FlopCounterMode``'s formula of each op it has one for),
    unfused bytes, kernel calls (``kernels.cost.call``), the chained
    products' time (``kernels.cost.chain``) and the live allocations'
    events."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        # FlopCounterMode's formulas, by aten op
        self.registry = FlopCounterMode(display=False).flop_registry
        self.depth = 0
        self.in_chain = 0
        self.flops = {}                # dtype -> unfused FLOPs
        self.hbm_bytes = 0
        self.kernels = {}              # name -> calls, flops, bytes
        self.compute_s = 0.0
        self.chain_s = 0.0             # this rank's chained products
        self.events = []               # ("a", serial, bytes) / ("f", serial)
        self._live = {}                # id(storage) -> serial
        self._serial = 0

    # ------------------------------------------------------ allocations

    def _free(self, key, serial):
        if self._live.get(key) == serial:
            del self._live[key]
        self.events.append(("f", serial))

    def track(self, tensors, exclude=()) -> None:
        """Record each new storage among ``tensors`` as an allocation."""
        skip = {id(_storage(t)) for t in exclude}
        for t in tensors:
            st = _storage(t)
            key = id(st)
            if key in skip or key in self._live:
                continue
            self._serial += 1
            self._live[key] = self._serial
            self.events.append(("a", self._serial, st.nbytes()))
            weakref.finalize(st, self._free, key, self._serial)

    def serial_of(self, t):
        return self._live.get(id(_storage(t)))

    # ------------------------------------------------------ ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        packet = func.overloadpacket
        formula = self.registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        ins = _flat((args, kwargs))
        outs = _flat(out)
        if not outs:                    # metadata (a device, a size)
            return out
        if func.is_view or packet.__name__ in _NO_TRAFFIC:
            self.track(outs, exclude=ins)
            return out
        in_st = {id(_storage(a)) for a in ins}
        fresh = [o for o in outs if id(_storage(o)) not in in_st]
        n_bytes = sum(_nbytes(a) for a in ins) + sum(_nbytes(o)
                                                     for o in fresh)
        dtype = next((t.dtype for t in ins + outs
                      if t.is_floating_point()), torch.float32)
        self.hbm_bytes += n_bytes
        if flops:
            key = cost.dtype_name(dtype)
            self.flops[key] = self.flops.get(key, 0) + flops
            t_ops = flops / cost.peak_ops_s(dtype)
            self.compute_s += t_ops
            if self.in_chain:
                self.chain_s += max(t_ops, n_bytes / cost.HBM_BYTES_S)
        self.track(fresh)
        return out

    # ------------------------------------------------------ hooks

    def record(self, name, ops, n_bytes, dtype) -> None:
        """One kernel op of ``ops`` operations and ``n_bytes`` bytes."""
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += ops
        rec["bytes"] += n_bytes
        self.hbm_bytes += n_bytes
        t_ops = ops / cost.peak_ops_s(dtype)
        self.compute_s += t_ops
        if self.in_chain:
            self.chain_s += max(t_ops, n_bytes / cost.HBM_BYTES_S)

    def kernel(self, name, cost_fn, fn, args):
        """A kernel wrapper's call (``kernels.cost.call``): one op. Under
        autograd (the training route's scans) its shape-only results are
        joined to its inputs (``_Attach``)."""
        if self.depth:
            return fn(*args)
        self.depth += 1
        try:
            out = fn(*args)
        finally:
            self.depth -= 1
        ops, n_bytes, dtype = cost_fn(out)
        self.record(name, ops, n_bytes, dtype)
        ins = _flat(args)
        grad_ins = [a for a in ins if a.requires_grad]
        if grad_ins and torch.is_grad_enabled():
            outs = _flat(out)
            new = _Attach.apply(self, (name + "_backward", 2 * ops,
                                       2 * n_bytes, dtype), len(outs),
                                *outs, *grad_ins)
            out = new[0] if isinstance(out, torch.Tensor) else tuple(new)
        self.track(_flat(out), exclude=ins)
        return out

    def chain(self):
        meter = self

        class _Chain:
            def __enter__(self):
                meter.in_chain += 1

            def __exit__(self, *exc):
                meter.in_chain -= 1

        return _Chain()

    # ------------------------------------------------------ results

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values())
                     + sum(k["flops"] for k in self.kernels.values()))

    def peak_excluding(self, serials) -> int:
        """The peak of live allocated bytes, ``serials`` left out."""
        live = peak = 0
        size = {}
        for ev in self.events:
            if ev[0] == "a":
                if ev[1] in serials:
                    continue
                size[ev[1]] = ev[2]
                live += ev[2]
                peak = max(peak, live)
            else:
                live -= size.pop(ev[1], 0)
        return peak


class _Attach(torch.autograd.Function):
    """A kernel's shape-only results joined to the inputs that need a
    gradient: its backward is one op of twice the kernel's operations
    and bytes (a reverse scan reads what the forward read and writes a
    gradient of each input), and hands each input an empty gradient."""

    @staticmethod
    def forward(ctx, meter, back, n_out, *ts):
        ctx.meter, ctx.back, ctx.n_out = meter, back, n_out
        ctx.like = [(t.shape, t.dtype) for t in ts[n_out:]]
        return tuple(t.new_empty(t.shape) for t in ts[:n_out])

    @staticmethod
    def backward(ctx, *grads):
        ctx.meter.record(*ctx.back)
        g = grads[0]
        return (None, None, None, *([None] * ctx.n_out),
                *(g.new_empty(shape, dtype=dt) for shape, dt in ctx.like))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _unique_bytes(tensors, exclude=()) -> int:
    """Bytes of the distinct storages among ``tensors``, those of
    ``exclude`` left out."""
    skip = {id(_storage(t)) for t in exclude}
    seen, total = set(), 0
    for t in tensors:
        key = id(_storage(t))
        if key in skip or key in seen:
            continue
        seen.add(key)
        total += _storage(t).nbytes()
    return total


def count(spec) -> dict:
    """Run ``spec``'s step under the meter; the per-device counts."""
    args = _tensors(spec.args)
    del spec.mesh.tally[:]
    meter = Meter()
    with spec.mode:
        with meter, cost.metering(meter):
            out = spec.fn(*spec.args)
        outs = _tensors(out)
        out_serials = {meter.serial_of(t) for t in outs} - {None}
        temp = meter.peak_excluding(out_serials)
    coll = {}
    coll_s = 0.0
    links = {}
    for kind, nb, size in spec.mesh.tally:
        rec = coll.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nb
        rate, link = cost.link_bytes_s(size)
        coll_s += nb / rate
        links[str(size)] = {"bytes_s": rate, "link": link}
    out_bytes = sum(_nbytes(t) for t in outs)
    if len(outs) > 1:
        out_bytes += TUPLE_INDEX_BYTES * len(outs)
    arg_bytes = sum(_nbytes(t) for t in args)
    layout = _unique_bytes(_tensors(spec.layout), exclude=args)
    fresh_out = _unique_bytes(outs, exclude=args)
    return {"meter": meter, "outputs": outs, "flops": meter.total_flops,
            "hbm_bytes": float(meter.hbm_bytes), "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "temp_bytes": temp,
            "serving_layout_bytes": layout,
            "output_not_argument_bytes": fresh_out,
            "collectives": coll, "collective_s": coll_s, "links": links}


def roofline_terms(c: dict, tp: int) -> dict:
    """Per-device seconds of each roofline term at H100 rates."""
    m = c["meter"]
    kernel_bytes = sum(k["bytes"] for k in m.kernels.values())
    return {
        "compute_s": m.compute_s,
        "memory_s": c["hbm_bytes"] / cost.HBM_BYTES_S,
        # the least the step must move: the larger of its kernels' own
        # bytes and its arguments read once plus its new outputs
        # written once (``memory_s`` is the unfused upper estimate)
        "memory_floor_s": max(kernel_bytes, c["argument_bytes"]
                              + c["output_not_argument_bytes"])
        / cost.HBM_BYTES_S,
        "collective_s": c["collective_s"],
        "collective_bytes": sum(v["bytes"]
                                for v in c["collectives"].values()),
        # the model line's ranks run their chained products one after
        # another: tp times this rank's
        "chain_s": tp * m.chain_s,
    }


TERMS = ("compute_s", "memory_s", "collective_s", "chain_s")


def model_flops(cfg, meta) -> float:
    """6*N*D (train) / 2*N*D (one forward) with N = active params."""
    n = cfg.active_param_count()
    if meta["kind"] == "train":
        tokens = meta["batch"] * meta["seq"]
        return 6.0 * n * tokens
    if meta["kind"] == "prefill":
        return 2.0 * n * meta["batch"] * meta["seq"]
    return 2.0 * n * meta["batch"] * meta["q_len"]


def SHAPE_KIND(shape_name: str) -> str:
    from repro_torch.launch.steps import SHAPES
    return SHAPES[shape_name]["kind"]


def config_for(arch: str, shape_name: str, tp: int):
    """The config a production step runs: bf16, the paper's block, the
    mesh's tensor parallelism, remat on the train step (as the
    reference's dry run)."""
    from repro_torch.launch import steps
    from repro_torch.models import get_config
    return get_config(arch, tp=tp, dtype="bfloat16", param_dtype="bfloat16",
                      block_size=steps.BLOCK,
                      **({"remat": True} if SHAPE_KIND(shape_name) == "train"
                         else {}))


def record(arch, shape_name, mesh, cfg, spec, c, variant, t0) -> dict:
    """The reference's record from a count."""
    n_chips = int(np.prod(list(mesh.shape.values())))
    terms = roofline_terms(c, mesh.shape["model"])
    mf = model_flops(cfg, spec.meta)
    flops = c["flops"]
    m = c["meter"]
    per = {
        "flops": flops,
        "hbm_bytes": c["hbm_bytes"],
        "argument_bytes": c["argument_bytes"],
        "output_bytes": c["output_bytes"],
        "temp_bytes": c["temp_bytes"],
        "cpu_promotion_bytes": None,
        "temp_bytes_tpu_estimate": None,
        "serving_layout_bytes": c["serving_layout_bytes"],
        "total_bytes": (c["argument_bytes"] + c["output_not_argument_bytes"]
                        + c["temp_bytes"] + c["serving_layout_bytes"]),
        "total_bytes_tpu_estimate": None,
        "flops_unfused_by_dtype": dict(m.flops),
        "kernels": m.kernels,
    }
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "variant": variant if spec.meta["kind"] == "decode" else "",
        "meta": spec.meta,
        "n_chips": n_chips,
        "rank": spec.coords,
        "per_device": per,
        "fits_80gb": per["total_bytes"] <= 80e9,
        "collectives": c["collectives"],
        "links": c["links"],
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else None,
        "unrolled": False,
        "compile_s": round(time.perf_counter() - t0, 1),
        "device": "H100 rates (kernels.cost); counted on shape-only tensors",
        "notes": NOTES,
    }
    rec["dominant_term"] = max(TERMS, key=lambda k: terms[k])
    return rec


def _tag(rec, variant) -> str:
    tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec["variant"] and rec["variant"] != "streaming":
        tag += f"__{variant}"
    return tag


def _write(rec, out_dir, tag) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _mesh(multi_pod, mesh_dims):
    from repro_torch.launch.mesh import make_production_mesh
    kw = dict(data=mesh_dims[0], model=mesh_dims[1]) if mesh_dims else {}
    return make_production_mesh(multi_pod=multi_pod, **kw)


def _counted(arch, shape_name, multi_pod, variant, mesh_dims):
    """The record of one (arch, shape, mesh) step's count."""
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    mesh = _mesh(multi_pod, mesh_dims)
    cfg = config_for(arch, shape_name, mesh.shape["model"])
    spec = steps.build(cfg, mesh, shape_name, variant=variant)
    return record(arch, shape_name, mesh, cfg, spec, count(spec), variant,
                  t0)


def _report(rec, out_dir, tag) -> None:
    _write(rec, out_dir, tag)
    t = rec["roofline"]
    per = rec["per_device"]
    print(f"OK {tag}: mem/dev={per['total_bytes'] / 2**30:.2f}GiB "
          f"flops/dev={per['flops']:.3g} dom={rec['dominant_term']} "
          f"terms=({t['compute_s']:.2e},{t['memory_s']:.2e},"
          f"{t['collective_s']:.2e},{t['chain_s']:.2e})s "
          f"count={rec['compile_s']}s", flush=True)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            variant: str = "streaming", out_dir: str = OUT_DIR,
            mesh_dims=None) -> dict:
    """Count one (arch, shape, mesh) step and write its record."""
    rec = _counted(arch, shape_name, multi_pod, variant, mesh_dims)
    _report(rec, out_dir, _tag(rec, variant))
    return rec


def run_corrected(arch: str, shape_name: str, variant: str = "streaming",
                  out_dir: str = ROOFLINE_DIR, mesh_dims=None,
                  multi_pod: bool = False) -> dict:
    """The reference's exact-trip-count record. The reference differences
    two compiles because XLA counts a scan's body once; the port's
    layers are a list, so one count already covers every layer."""
    rec = _counted(arch, shape_name, multi_pod, variant, mesh_dims)
    rec.update(unrolled=True, method="one_pass_layers_unrolled")
    _report(rec, out_dir, _tag(rec, variant) + "__unrolled")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="streaming")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--mesh-dims", default="",
                    help="testing only: 'data,model' override")
    args = ap.parse_args(argv)
    mesh_dims = tuple(int(x) for x in args.mesh_dims.split(",")) \
        if args.mesh_dims else None

    if args.all:
        from repro_torch.launch.steps import SHAPES
        failures = []
        t0 = time.perf_counter()
        for arch in ASSIGNED:
            for shape in SHAPES:
                for mp in (False, True):
                    try:
                        run_one(arch, shape, mp, out_dir=args.out)
                    except Exception as e:
                        failures.append((arch, shape, mp, repr(e)))
                        print(f"FAIL {arch} {shape} mp={mp}: {e}")
                        traceback.print_exc()
        print(f"{len(failures)} failures in "
              f"{time.perf_counter() - t0:.1f}s")
        raise SystemExit(1 if failures else 0)
    run_one(args.arch, args.shape, args.multi_pod, args.variant, args.out,
            mesh_dims=mesh_dims)


if __name__ == "__main__":
    main()
