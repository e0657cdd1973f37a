"""Production step functions and their shape-only inputs: the PyTorch
counterpart of ``repro.launch.steps``.

One builder per input-shape class:
  train_4k    -> train_step   (masked-diffusion loss + AdamW update)
  prefill_32k -> prefill_step (build KV caches / recurrent states)
  decode_32k  -> serve_step   (ONE denoise iteration of the current
                               block against the full cache; streaming
                               variant uses the pruned query region,
                               frozen the block alone, baseline the
                               full suffix)
  long_500k   -> serve_step   (batch 1, context-parallel cache, local
                               attention for dense archs)

The port is SPMD (``launch.mesh``): a spec's step is what ONE rank of
the mesh runs on its own shards. ``build`` returns a ``LoweringSpec``:

- ``fn``: the step, on the port's ``apply_model``, ``diffusion_loss``,
  ``adamw_update`` and ``confidence_and_tokens`` (nothing of the
  decoder, its graphs or its streams). Serving steps take the kernel
  route (``use_kernels``; on the CPU the kernels' plain versions), the
  train step the training route (``train=True``), as the card runs them;
- ``args``: the rank's shards as shape-only tensors, fake tensors of
  ``mode`` (a ``FakeTensorMode``) on the explicit ``DEVICE``, "cpu",
  so the route is the same on every machine and nothing is
  allocated; ``run`` calls ``fn`` inside ``mode``;
- ``in_specs`` / ``out_specs``: the placements as the port's ``P``
  trees, from ``SpecBuilder`` in the step's mode (None where the
  reference has no placement);
- ``meta``: the reference's;
- ``mesh``: the mesh as the counted rank sees it (``Mesh.for_count``),
  whose lines tally the collectives the step issues, and ``coords``
  that rank: the first of every data line and the last of the model
  line. The last rank of a row-parallel chain (``models.layers.
  row_parallel``) receives the partial sum, multiplies and broadcasts,
  so its products lie on the path to the loss.

The train step shards as the reference's train mode does (FSDP over
``data`` and tensor parallelism over ``model``): it all-gathers each
FSDP-sharded leaf over the data line before the forward (the gather's
adjoint, a reduce-scatter, sums its gradient), sums every other
gradient over the data axes the leaf is not sharded on, and updates its
own shards with AdamW. The training route keeps the MoE on its dense
path over the rank's experts (``models.moe.apply_moe``: no all-to-all
under autograd).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.schedule import confidence_and_tokens
from repro_torch.launch.mesh import data_axes_of
from repro_torch.launch.sharding import P, SpecBuilder, _guard, _shapes
from repro_torch.launch.sharding import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (DTYPES, apply_model, init_cache,
                                      init_params, serving_layout)
from repro_torch.training import tree
from repro_torch.training.loss import (diffusion_loss, frontend_draw,
                                       loss_given_noise)
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode", long=True),
}

# paper defaults: block 32, window 96, gen length 512 (Table 12)
BLOCK = 32
WINDOW = 96
GEN_LEN = 512
# the shape-only tensors' device: explicit, never the card, so a count
# takes the same route (the kernels' plain bodies, no kernel library) on
# every machine
DEVICE = "cpu"


class LoweringSpec(NamedTuple):
    fn: Any                 # one rank's step
    args: Tuple             # its shards, shape-only (fake tensors of mode)
    in_specs: Tuple         # P trees (None: no placement)
    out_specs: Any
    meta: dict
    mesh: Any               # the counted rank's view (Mesh.for_count)
    mode: Any               # the FakeTensorMode of args
    coords: dict            # the counted rank's index on each axis
    layout: Tuple = ()      # serving layouts built once (not arguments)

    def run(self):
        """``fn(*args)`` inside the args' mode."""
        with self.mode:
            return self.fn(*self.args)


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    # trillion-param MoE: bf16 moments to fit 16G HBM (DESIGN.md §7)
    bf16 = cfg.param_count() > 200e9
    return AdamWConfig(state_dtype="bfloat16" if bf16 else "float32")


# ------------------------------------------------------------- shards

def counted_coords(mesh) -> dict:
    """The rank a spec counts: index 0 on every axis but ``model``, the
    last there."""
    return {a: (mesh.shape[a] - 1 if a == "model" else 0)
            for a in mesh.axis_names}


def shard_shape(shape, spec: P, mesh) -> tuple:
    """One rank's shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for dim, names in enumerate(spec):
        if names is None:
            continue
        for a in (names if isinstance(names, tuple) else (names,)):
            out[dim] //= mesh.shape[a]
    return tuple(out)


@functools.lru_cache(maxsize=4)
def param_shapes(cfg: ModelConfig):
    """The whole params tree as fake tensors (shapes and dtypes only)."""
    return _shapes(lambda: init_params(cfg, torch.Generator(), device=DEVICE))


def _shards(mode, full, specs, mesh, dtype=None):
    """A tree of shape-only shards of ``full``'s leaves under ``specs``."""
    with mode:
        return tree_map(lambda t, sp: torch.empty(
            shard_shape(t.shape, sp, mesh), dtype=dtype or t.dtype,
            device=DEVICE), full, specs, is_leaf=lambda x: isinstance(x, P))


def _array(mode, shape, dtype, spec, mesh):
    spec = _guard(spec, shape, mesh)
    with mode:
        return torch.empty(shard_shape(shape, spec, mesh), dtype=dtype,
                           device=DEVICE), spec


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


# --------------------------------------------------------------- train

def _gather_fsdp(p, fsdp_dims, data):
    """All-gather the FSDP-sharded dims of one leaf over the data line."""
    for dim in fsdp_dims:
        p = data.all_gather(p, dim)
    return p


def build_train(cfg: ModelConfig, mesh, shape=SHAPES["train_4k"]
                ) -> LoweringSpec:
    da = data_axes_of(mesh)
    opt_cfg = opt_config_for(cfg)
    coords = counted_coords(mesh)
    cm = mesh.for_count(coords)
    B, S = shape["batch"], shape["seq"]
    sb = SpecBuilder(cfg, mesh, mode="train")
    full = param_shapes(cfg)
    pspec = sb.params(shapes=full)
    serve = SpecBuilder(cfg, mesh, mode="serve").params(shapes=full)
    ospec = sb.opt(pspec)
    bspec = sb.batch_spec(1)
    spec_leaves = tree.flatten(pspec)[0]
    # dims the train mode shards over data and the serve mode does not:
    # FSDP (an expert axis on data is expert parallelism in both modes)
    fsdp = [tuple(i for i, (t, s) in enumerate(zip(tl, sl))
                  if t is not None and s is None)
            for tl, sl in zip(spec_leaves, tree.flatten(serve)[0])]
    # the data axes each gradient is summed over: those its leaf is not
    # sharded on (an FSDP dim's reduce-scatter sums over data already)
    grad_axes = [tuple(a for a in da
                       if not any(a == n or (isinstance(n, tuple) and a in n)
                                  for n in sp))
                 for sp in spec_leaves]

    def step(params, opt_state, tokens, loss_mask, loss_fn):
        leaves, treedef = tree.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        data = cm.group("data") if "data" in cm.shape else None
        whole = [_gather_fsdp(p, dims, data) if dims else p
                 for p, dims in zip(leaves, fsdp)]
        loss, metrics = loss_fn(tree.unflatten(treedef, whole))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = [cm.group(ax).all_reduce(g) if ax else g
                 for g, ax in zip(grads, grad_axes)]
        new, opt_state2, om = adamw_update(
            opt_cfg, list(grads), opt_state, [p.detach() for p in leaves])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (tree.unflatten(treedef, new), opt_state2,
                dict(metrics, loss=loss.detach(), **om))

    def train_step(params, opt_state, tokens, loss_mask, prefix_embeds, rng):
        return step(params, opt_state, tokens, loss_mask,
                    lambda p: diffusion_loss(cfg, p, tokens, loss_mask, rng,
                                             mesh=cm))

    def train_step_frontend(params, opt_state, tokens, loss_mask,
                            prefix_embeds, rng):
        # modality archs: loss over the token region, conditioned on the
        # (stub) frontend prefix embeddings (the reference's _dl_frontend)
        t, mask = frontend_draw(loss_mask, rng)
        return step(params, opt_state, tokens, loss_mask,
                    lambda p: loss_given_noise(
                        cfg, p, tokens, t, mask, mesh=cm,
                        prefix_embeds=prefix_embeds))

    mode = _fake_mode()
    params = _shards(mode, full, pspec, mesh)
    moments = [_shards(mode, t, s, mesh,
                       dtype=DTYPES[opt_cfg.state_dtype])
               for t, s in zip(tree.flatten(full)[0], spec_leaves)]
    opt_state = AdamWState(0, moments, [_shards(
        mode, t, s, mesh, dtype=DTYPES[opt_cfg.state_dtype])
        for t, s in zip(tree.flatten(full)[0], spec_leaves)])
    Pf = cfg.frontend_prefix_len if cfg.frontend_embed_dim else 0
    S_tok = S - Pf
    tokens, tspec = _array(mode, (B, S_tok), torch.int32, bspec, mesh)
    mask, _ = _array(mode, (B, S_tok), torch.bool, bspec, mesh)
    emb, espec = _array(mode, (B, Pf, max(cfg.frontend_embed_dim, 1)),
                        torch.bfloat16, sb.batch_spec(2), mesh)
    fn = train_step if not Pf else train_step_frontend
    args = (params, opt_state, tokens, mask, emb, torch.Generator())
    insh = (pspec, ospec, tspec, tspec, espec, None)
    outsh = (pspec, ospec, None)
    return LoweringSpec(fn, args, insh, outsh,
                        dict(kind="train", batch=B, seq=S), cm, mode, coords)


# --------------------------------------------------------------- prefill

def _long(cfg: ModelConfig, serve_long: bool) -> ModelConfig:
    """The config a long-context pass runs: every global attention layer
    local (the reference's ``serve_long``)."""
    return dataclasses.replace(cfg, force_local_attention=True) \
        if serve_long else cfg


def _serving_args(mode, cfg, full, pspec, mesh):
    """The params' shards, and the tensors of their serving layouts,
    built now (a tied head's contiguous copy, the recurrent mixers'
    concatenations: the decoder builds them once, before its first
    step, and the step finds them built)."""
    from repro_torch.models import recurrent as rec
    params = _shards(mode, full, pspec, mesh)
    with mode:
        layout = [serving_layout(cfg, params)]
        for spec, p in zip(cfg.layout, params["layers"]):
            if spec.mixer in rec.APPLY:
                layout += rec.mixer_weights(spec.mixer, p["mixer"]).values()
    return params, tuple(layout)


def build_prefill(cfg: ModelConfig, mesh, shape=SHAPES["prefill_32k"],
                  serve_long=False) -> LoweringSpec:
    da = data_axes_of(mesh)
    coords = counted_coords(mesh)
    cm = mesh.for_count(coords)
    B, S = shape["batch"], shape["seq"]
    max_len = S + GEN_LEN
    ctx_par = bool(shape.get("long")) and B == 1
    moe_da = () if ctx_par else da
    run_cfg = _long(cfg, serve_long)

    def prefill_step(params, tokens, prefix_embeds, cache):
        out = apply_model(run_cfg, params, tokens=tokens,
                          prefix_embeds=prefix_embeds if
                          cfg.frontend_embed_dim else None,
                          mode="encode", cache=cache, use_kernels=True,
                          mesh=cm, data_axes=moe_da)
        return out.cache, out.kv_valid

    sb = SpecBuilder(cfg, mesh, mode="serve")
    full = param_shapes(cfg)
    pspec = sb.params(shapes=full)
    full_cache = _shapes(lambda: init_cache(cfg, B, max_len, DEVICE))
    cspec = sb.cache(B, max_len, serve_long, ctx_parallel=ctx_par,
                     shapes=full_cache)
    mode = _fake_mode()
    params, layout = _serving_args(mode, cfg, full, pspec, mesh)
    cache = _shards(mode, full_cache, cspec, mesh)
    Pf = cfg.frontend_prefix_len if cfg.frontend_embed_dim else 0
    tokens, tspec = _array(mode, (B, S - Pf), torch.int32,
                           sb.batch_spec(1) if not ctx_par
                           else P(None, "data"), mesh)
    emb, espec = _array(mode, (B, Pf, max(cfg.frontend_embed_dim, 1)),
                        torch.bfloat16, sb.batch_spec(2) if not ctx_par
                        else P(None, None, None), mesh)
    args = (params, tokens, emb, cache)
    insh = (pspec, tspec, espec, cspec)
    outsh = (cspec, sb.batch_spec(0) if not ctx_par else P(None))
    return LoweringSpec(prefill_step, args, insh, outsh,
                        dict(kind="prefill", batch=B, seq=S), cm, mode,
                        coords, layout)


# --------------------------------------------------------------- decode

def build_serve(cfg: ModelConfig, mesh, shape, variant="streaming"
                ) -> LoweringSpec:
    da = data_axes_of(mesh)
    coords = counted_coords(mesh)
    cm = mesh.for_count(coords)
    B, S = shape["batch"], shape["seq"]
    serve_long = bool(shape.get("long"))
    ctx_par = serve_long and B == 1
    moe_da = () if ctx_par or B < mesh.shape.get("data", 1) else da
    K = cfg.block_size
    if variant == "streaming":
        Sq = K + WINDOW + 1
    elif variant == "frozen":
        # HC1 (EXPERIMENTS.md §Perf): frozen-suffix steps query only the
        # block; suffix/trailing KV are read from the cache (bool mask)
        Sq = K
    else:  # paper baseline: full suffix of a gen-512 target (block 0)
        Sq = GEN_LEN
    run_cfg = _long(cfg, serve_long)

    def serve_step(params, q_tokens, q_pos, cache, kv_valid):
        out = apply_model(run_cfg, params, tokens=q_tokens, positions=q_pos,
                          mode="step", cache=cache, kv_valid=kv_valid,
                          use_kernels=True, mesh=cm, data_axes=moe_da)
        conf, toks = confidence_and_tokens(out.logits[:, :K])
        return conf, toks

    sb = SpecBuilder(cfg, mesh, mode="serve")
    full = param_shapes(cfg)
    pspec = sb.params(shapes=full)
    full_cache = _shapes(lambda: init_cache(cfg, B, S, DEVICE))
    cspec = sb.cache(B, S, serve_long, ctx_parallel=ctx_par,
                     shapes=full_cache)
    bspec = sb.batch_spec(1) if not ctx_par else P(None, None)
    b0 = sb.batch_spec(0) if not ctx_par else P(None)
    mode = _fake_mode()
    params, layout = _serving_args(mode, cfg, full, pspec, mesh)
    cache = _shards(mode, full_cache, cspec, mesh)
    q_tokens, qspec = _array(mode, (B, Sq), torch.int32, bspec, mesh)
    q_pos, _ = _array(mode, (B, Sq), torch.int32, bspec, mesh)
    if variant == "frozen":
        kv_valid, kspec = _array(mode, (B, S), torch.bool,
                                 sb.batch_spec(1) if not ctx_par
                                 else P(None, "data"), mesh)
    else:
        kv_valid, kspec = _array(mode, (B,), torch.int32, b0, mesh)
    args = (params, q_tokens, q_pos, cache, kv_valid)
    insh = (pspec, qspec, qspec, cspec, kspec)
    outsh = (qspec, qspec)
    return LoweringSpec(serve_step, args, insh, outsh,
                        dict(kind="decode", batch=B, seq=S, q_len=Sq,
                             variant=variant, long=serve_long), cm, mode,
                        coords, layout)


def build(cfg: ModelConfig, mesh, shape_name: str,
          variant: str = "streaming") -> LoweringSpec:
    shape = SHAPES[shape_name]
    if shape["kind"] == "train":
        return build_train(cfg, mesh, shape)
    if shape["kind"] == "prefill":
        return build_prefill(cfg, mesh, shape)
    return build_serve(cfg, mesh, shape, variant=variant)
