"""The port's dry run (``repro_torch.launch.steps`` / ``dryrun``, ROADMAP
A14) against the JAX package's (``repro.launch.steps`` / ``dryrun``).

- The shapes, the paper's block, window and gen length, and each
  builder's ``meta`` equal the reference's.
- The placements equal JAX's ``steps.build`` in- and out-shardings leaf
  for leaf, in the reference's own cases (``tests/test_sharding.py``):
  tiny ``decode_32k``, tiny-moe ``train_4k`` and xlstm-350m-smoke
  ``long_500k`` on (2, 4), tiny-moe ``decode_32k`` on (2, 2, 2), and the
  frozen and baseline variants. JAX's builder reads only a mesh's shape
  and axis names once its ``NamedSharding`` wrap is taken off (``_ns``),
  so a stand-in mesh serves in process and no host devices are forced.
- The record against the reference's fully unrolled record of tiny
  ``decode_32k`` on (2, 4) (a subprocess, ~8 s): meta, mesh, chips, model
  FLOPs, argument and output bytes equal; per-device FLOPs within
  ``FLOP_TOL`` below XLA's (measured: 2.914e11 against 3.109e11, 6.3 %
  fewer). The rest is XLA counting elementwise work (the softmax's max,
  subtract, exp, sum and divide over 64 x 129 x 32897 scores a head and
  layer, the masks' selects, RMSNorm, RoPE), which FlopCounterMode's
  formulas do not; the products and attention's two contractions agree.
- Tiny's serve step on (1, 1) against a hand count: its FLOPs are the
  products' 2 M K N plus attention's 4 B Sq Skv H D, exactly.
- The card machine's route: with ``torch.cuda.is_available`` patched
  True and every kernel library's loader patched to raise, ``run_one``
  counts every case above the same, no tensor of the count is a real
  one, and no launch is counted.
- kimi-k2 ``decode_32k`` on the production (16, 16) mesh, which fits no
  card's step at full size, is counted on the CPU (about 10 s).
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import get_config as jget_config
from repro_torch.kernels import build, cost, ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import P
from repro_torch.training import tree

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the port's per-device FLOPs at most this far below XLA's (module doc)
FLOP_TOL = 0.10

# (arch, shape, (data, model), multi_pod, variant): the reference's cases
CASES = [("tiny", "decode_32k", (2, 4), False, "streaming"),
         ("tiny-moe", "train_4k", (2, 4), False, "streaming"),
         ("xlstm-350m-smoke", "long_500k", (2, 4), False, "streaming"),
         ("tiny-moe", "decode_32k", (2, 2), True, "streaming"),
         ("tiny", "decode_32k", (2, 4), False, "frozen"),
         ("tiny", "decode_32k", (2, 4), False, "baseline")]


class _JaxMesh:
    """What the JAX builder reads of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _axes(multi_pod):
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def jax_spec(monkeypatch, arch, shape, dims, multi_pod, variant):
    """The reference's ``steps.build`` with its shardings left as
    ``PartitionSpec`` trees."""
    monkeypatch.setattr(jsteps, "_ns", lambda mesh, t: t)
    mesh = _JaxMesh(((2,) if multi_pod else ()) + dims, _axes(multi_pod))
    remat = {"remat": True} if jsteps.SHAPES[shape]["kind"] == "train" \
        else {}
    cfg = jget_config(arch, tp=mesh.shape["model"], dtype="bfloat16",
                      param_dtype="bfloat16", block_size=jsteps.BLOCK,
                      **remat)
    return cfg, jsteps.build(cfg, mesh, shape, variant=variant)


def port_spec(arch, shape, dims, multi_pod, variant):
    mesh = make_production_mesh(multi_pod=multi_pod, data=dims[0],
                                model=dims[1])
    cfg = dryrun.config_for(arch, shape, mesh.shape["model"])
    return cfg, mesh, steps.build(cfg, mesh, shape, variant=variant)


# ------------------------------------------------------------ spec trees

def _is_p(x):
    return type(x).__name__ == "PartitionSpec"


def _layers(cfg, jtree, unstack):
    """A JAX scan-stacked tree of per-layer specs in the port's layout:
    one entry per layer (pattern repeats, then the tail)."""
    n_pos = len(cfg.pattern)
    drop = (lambda s: P(*tuple(s)[1:])) if unstack else (lambda s: P(*s))
    out = [jax.tree.map(drop, jtree["scan"][j], is_leaf=_is_p)
           for _ in range(cfg.reps) for j in range(n_pos)]
    return out + [jax.tree.map(lambda s: P(*s), t, is_leaf=_is_p)
                  for t in jtree["tail"]]


def _jparams(cfg, jtree):
    out = {k: P(*v) for k, v in jtree.items() if k not in ("scan", "tail")}
    out["layers"] = _layers(cfg, jtree, True)
    return out


def _plain(t):
    """Spec trees (the port's ``P`` or JAX's ``PartitionSpec`` leaves) ->
    dicts, lists and one tuple of entries a leaf."""
    if isinstance(t, P) or _is_p(t):
        return tuple(t)
    if isinstance(t, dict):
        return {k: _plain(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_plain(v) for v in t]
    return t


def _want(cfg, kind, jtree):
    """One of the reference's placements in the port's layout."""
    if jtree is None:
        return None
    if kind == "params":
        return _plain(_jparams(cfg, jtree))
    if kind == "opt":
        return [(), _plain(_jparams(cfg, jtree.m)),
                _plain(_jparams(cfg, jtree.v))]
    if kind == "cache":
        return _plain(_layers(cfg, jtree, True))
    return _plain(jtree)


def _got(kind, spec, pspec):
    if spec is None:
        return None
    if kind == "opt":
        treedef = tree.flatten(pspec)[1]
        return [tuple(spec.step), _plain(tree.unflatten(treedef, spec.m)),
                _plain(tree.unflatten(treedef, spec.v))]
    return _plain(spec)


KINDS = {"train": (("params", "opt", "batch", "batch", "batch", None),
                   ("params", "opt", None)),
         "prefill": (("params", "batch", "batch", "cache"),
                     ("cache", "batch")),
         "decode": (("params", "batch", "batch", "cache", "batch"),
                    ("batch", "batch"))}


# ------------------------------------------------------------ the tests

def test_shapes_and_paper_defaults_equal_reference():
    assert steps.SHAPES == jsteps.SHAPES
    assert (steps.BLOCK, steps.WINDOW, steps.GEN_LEN) == (
        jsteps.BLOCK, jsteps.WINDOW, jsteps.GEN_LEN)
    for arch in ("tiny", "kimi-k2-1t-a32b", "qwen3-32b"):
        assert steps.opt_config_for(dryrun.config_for(
            arch, "train_4k", 16)) == steps.AdamWConfig(
            state_dtype=jsteps.opt_config_for(jget_config(arch))
            .state_dtype)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    [c[0], c[1], "x".join(map(str, c[2])), "mp" if c[3] else "", c[4]]))
def test_meta_and_placements_equal_jax(monkeypatch, case):
    jcfg, want = jax_spec(monkeypatch, *case)
    cfg, mesh, got = port_spec(*case)
    assert got.meta == want.meta
    ins, outs = KINDS[got.meta["kind"]]
    pspec = got.in_specs[0]
    assert len(got.in_specs) == len(want.in_shardings) == len(ins)
    for kind, g, w in zip(ins, got.in_specs, want.in_shardings):
        assert _got(kind, g, pspec) == _want(jcfg, kind, w), kind
    for kind, g, w in zip(outs, got.out_specs, want.out_shardings):
        assert _got(kind, g, pspec) == _want(jcfg, kind, w), kind
    # each argument is the counted rank's shard of its placement
    coords = got.coords
    assert coords["model"] == mesh.shape["model"] - 1
    assert all(coords[a] == 0 for a in mesh.axis_names if a != "model")
    assert all(cost.shape_only(t) and t.device.type == "cpu"
               for t in dryrun._tensors(got.args))


def test_record_against_the_reference_unrolled_record(tmp_path):
    env = dict(os.environ,
               REPRO_XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "tiny",
         "--shape", "decode_32k", "--mesh-dims", "2,4", "--unroll", "-1",
         "--out", str(tmp_path / "ref")], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = json.loads((tmp_path / "ref" /
                       "tiny__decode_32k__2x4__unrolled.json").read_text())
    got = dryrun.run_one("tiny", "decode_32k", False,
                         out_dir=str(tmp_path / "port"), mesh_dims=(2, 4))
    assert json.loads((tmp_path / "port" / "tiny__decode_32k__2x4.json")
                      .read_text())["meta"] == got["meta"]
    for key in ("meta", "mesh", "n_chips", "model_flops_global", "variant"):
        assert got[key] == want[key], key
    for key in ("argument_bytes", "output_bytes"):
        assert got["per_device"][key] == want["per_device"][key], key
    assert want["per_device"]["argument_bytes"] == 1075467520
    f_got, f_want = got["per_device"]["flops"], want["per_device"]["flops"]
    assert (1 - FLOP_TOL) * f_want <= f_got <= f_want
    # its keys are the reference's (a few more of its own)
    assert set(want) <= set(got) | {"unrolled"}
    assert set(want["per_device"]) <= set(got["per_device"])
    assert got["per_device"]["cpu_promotion_bytes"] is None
    assert set(got["roofline"]) >= set(want["roofline"])
    assert got["dominant_term"] in dryrun.TERMS
    corrected = dryrun.run_corrected("tiny", "decode_32k",
                                     out_dir=str(tmp_path / "roof"),
                                     mesh_dims=(2, 4))
    assert corrected["unrolled"] and corrected["per_device"]["flops"] == \
        f_got
    assert os.listdir(tmp_path / "roof") == [
        "tiny__decode_32k__2x4__unrolled.json"]


def test_tiny_serve_step_flops_are_the_hand_count():
    """(1, 1): every product goes through ``ops.linear`` (one gemm op of
    2 M K N) and every attention through ``ops.block_attention`` (4 B Sq
    Skv H D over all keys of a shape-only mask); nothing else counts."""
    cfg = dryrun.config_for("tiny", "decode_32k", 1)
    mesh = make_production_mesh(data=1, model=1)
    B, S = 2, 64
    spec = steps.build_serve(cfg, mesh, dict(seq=S, batch=B, kind="decode"))
    c = dryrun.count(spec)
    Sq, d, hd = spec.meta["q_len"], cfg.d_model, cfg.head_dim
    M = B * Sq
    per_layer = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                 (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
                 (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    products = [kn for _ in range(cfg.n_layers) for kn in per_layer]
    products.append((d, cfg.vocab_size))
    gemm = sum(2 * M * K * N for K, N in products)
    attn = cfg.n_layers * 4 * B * Sq * (S + Sq) * cfg.n_heads * hd
    kernels = c["meter"].kernels
    assert kernels["gemm"] == {"calls": len(products), "flops": gemm,
                               "bytes": kernels["gemm"]["bytes"]}
    assert kernels["block_attention"]["calls"] == cfg.n_layers
    assert kernels["block_attention"]["flops"] == attn
    assert c["flops"] == gemm + attn
    assert c["collectives"] == {}
    # the memory floor: the kernels' own bytes (here above the arguments
    # read once), below the unfused estimate
    terms = dryrun.roofline_terms(c, 1)
    k_bytes = sum(k["bytes"] for k in kernels.values())
    assert k_bytes > c["argument_bytes"] + c["output_not_argument_bytes"]
    assert terms["memory_floor_s"] == k_bytes / cost.HBM_BYTES_S
    assert terms["memory_floor_s"] < terms["memory_s"]
    assert c["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in dryrun._tensors(spec.args))


def _card_machine(monkeypatch):
    """What differs on the machine with the card: CUDA is there, and a
    kernel library would load. Any load fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the count reached a kernel library")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "compile_library", refuse)
    from repro_torch.kernels import (block_attention, confidence, gemm,
                                     recurrent)
    for mod in (block_attention, confidence, gemm, recurrent):
        monkeypatch.setattr(mod, "_lib", refuse)


@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: f"{c[0]}-{c[1]}")
def test_the_card_machines_route_counts_the_same(monkeypatch, tmp_path,
                                                 case):
    arch, shape, dims, multi_pod, variant = case
    plain = dryrun.run_one(arch, shape, multi_pod, variant,
                           str(tmp_path / "a"), mesh_dims=dims)
    _card_machine(monkeypatch)
    ops.reset_launches()
    cfg, mesh, spec = port_spec(*case)
    c = dryrun.count(spec)
    assert all(cost.shape_only(t) for t in dryrun._tensors(spec.args))
    assert all(cost.shape_only(t) for t in c["outputs"])
    assert not any(ops.LAUNCHES.values())
    card = dryrun.run_one(arch, shape, multi_pod, variant,
                          str(tmp_path / "b"), mesh_dims=dims)
    for key in ("per_device", "collectives", "roofline", "meta"):
        assert card[key] == plain[key], key
    assert c["flops"] == plain["per_device"]["flops"]


def test_kimi_k2_decode_on_the_production_mesh(tmp_path):
    """A 1T-parameter MoE's decode step on (16, 16), counted on the CPU:
    one rank's experts (384 over data 16: 24) and heads, its KV shard."""
    t0 = time.perf_counter()
    rec = dryrun.run_one("kimi-k2-1t-a32b", "decode_32k", False,
                         out_dir=str(tmp_path))
    seconds = time.perf_counter() - t0
    print(f"kimi-k2 decode_32k (16, 16) counted in {seconds:.1f} s")
    per = rec["per_device"]
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert per["flops"] > 0 and per["argument_bytes"] > 8e9
    assert {"all_to_all", "recv", "broadcast"} <= set(rec["collectives"])
    assert rec["links"]["16"]["link"] == "network (assumed)"
    assert rec["dominant_term"] in dryrun.TERMS
    assert seconds < 120


def test_the_steps_run_on_real_tensors_as_the_port_does():
    """On a (1, 1) mesh the specs' step functions, given real tensors, are
    the port's own passes: the train step equals ``make_train_step`` on
    the same draw (bit for bit), the serve step ``apply_model`` and
    ``confidence_and_tokens``, the prefill step an encode into the
    cache."""
    from repro_torch.core.schedule import confidence_and_tokens
    from repro_torch.models.model import apply_model, init_cache, init_params
    from repro_torch.training.loss import draw_noise
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train import make_train_step
    cfg = steps.dataclasses.replace(
        dryrun.config_for("tiny", "decode_32k", 1), dtype="float32",
        param_dtype="float32")
    mesh = make_production_mesh(data=1, model=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    B, S = 2, 24
    tokens = torch.randint(0, cfg.vocab_size - 2, (B, S), generator=gen,
                           dtype=torch.int32)
    mask = torch.ones((B, S), dtype=torch.bool)
    spec = steps.build_train(cfg, mesh, dict(seq=S, batch=B, kind="train"))
    opt_cfg = steps.opt_config_for(cfg)
    leaves = tree.flatten(params)[0]
    got = spec.fn(params, adamw_init(opt_cfg, leaves), tokens, mask,
                  torch.zeros((B, 0, 1)), torch.Generator().manual_seed(7))
    want = make_train_step(cfg, opt_cfg)(
        params, adamw_init(opt_cfg, leaves), tokens,
        draw_noise(mask, torch.Generator().manual_seed(7)))
    for a, b in zip(tree.flatten(got[0])[0], tree.flatten(want[0])[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(got[2]["loss"]) == float(want[2]["loss"])

    T = 40
    spec = steps.build_serve(cfg, mesh, dict(seq=T, batch=B, kind="decode"))
    Sq = spec.meta["q_len"]
    q = torch.randint(0, cfg.vocab_size - 2, (B, Sq), generator=gen,
                      dtype=torch.int32)
    pos = (8 + torch.arange(Sq, dtype=torch.int32))[None].expand(B, Sq)
    cache = init_cache(cfg, B, T, "cpu")
    for k, v in cache:
        k.normal_(generator=gen)
        v.normal_(generator=gen)
    kv_valid = torch.full((B,), 8, dtype=torch.int32)
    conf, toks = spec.fn(params, q, pos, cache, kv_valid)
    out = apply_model(cfg, params, tokens=q, positions=pos, mode="step",
                      cache=cache, kv_valid=kv_valid, use_kernels=True)
    c2, t2 = confidence_and_tokens(out.logits[:, :cfg.block_size])
    torch.testing.assert_close(conf, c2, rtol=0, atol=0)
    assert torch.equal(toks, t2)

    spec = steps.build_prefill(cfg, mesh, dict(seq=S, batch=B,
                                               kind="prefill"))
    cache = init_cache(cfg, B, S + steps.GEN_LEN, "cpu")
    filled, valid = spec.fn(params, tokens, torch.zeros((B, 0, 1)), cache)
    assert filled is cache and torch.equal(valid, torch.full((B,), S))
    assert bool(cache[0][0][:, :S].abs().sum() > 0)
    assert not bool(cache[0][0][:, S:].abs().sum() > 0)


def test_the_frontend_train_step_runs_on_real_tensors():
    """A modality config's train step (``_dl_frontend``'s counterpart) on
    a (1, 1) mesh, given real tensors: ``frontend_draw`` from the step's
    generator, ``loss_given_noise`` over the token region after the
    prefix, then AdamW, bit for bit; ``frontend_proj`` gets a gradient.
    Its loss against the JAX package's is
    ``tests/test_torch_frontends.py``."""
    from repro_torch.models.config import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training.loss import frontend_draw, loss_given_noise
    from repro_torch.training.optimizer import adamw_init, adamw_update
    cfg = get_config("llava-next-34b-smoke")
    mesh = make_production_mesh(data=1, model=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    B, S, Pf = 2, 24, cfg.frontend_prefix_len
    tokens = torch.randint(0, cfg.vocab_size - 2, (B, S), generator=gen,
                           dtype=torch.int32)
    mask = torch.ones((B, S), dtype=torch.bool)
    mask[1, :5] = False
    pe = torch.randn((B, Pf, cfg.frontend_embed_dim), generator=gen)
    spec = steps.build_train(cfg, mesh, dict(seq=S + Pf, batch=B,
                                             kind="train"))
    assert spec.args[2].shape == (B, S) and spec.args[4].shape == pe.shape
    opt_cfg = steps.opt_config_for(cfg)
    leaves, td = tree.flatten(params)
    got = spec.fn(params, adamw_init(opt_cfg, leaves), tokens, mask, pe,
                  torch.Generator().manual_seed(7))
    t, m = frontend_draw(mask, torch.Generator().manual_seed(7))
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_given_noise(cfg, tree.unflatten(td, live), tokens,
                                     t, m, prefix_embeds=pe)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    want, _, _ = adamw_update(opt_cfg, list(grads),
                              adamw_init(opt_cfg, leaves), leaves)
    for a, b in zip(tree.flatten(got[0])[0], want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(got[2]["loss"]) == float(loss.detach())
    assert float(got[2]["ce"]) == float(metrics["ce"].detach())
    assert bool(torch.isfinite(loss)) and int(got[2]["n_masked"]) > 0
    i = next(i for i, p in enumerate(leaves) if p is params["frontend_proj"])
    assert bool(grads[i].abs().sum() > 0)


def test_a_meter_refuses_tensors_that_hold_values():
    """Under a dry run's meter a kernel wrapper makes empty results in
    place of its work; given a tensor with values it raises instead."""
    x, w = torch.ones((4, 8)), torch.ones((8, 16))
    with cost.metering(dryrun.Meter()):
        with pytest.raises(RuntimeError, match="holds values"):
            ops.linear(x, w)
    torch.testing.assert_close(ops.linear(x, w), x @ w)
