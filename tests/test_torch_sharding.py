"""The port's partition specs (``repro_torch.launch.sharding``) against
the JAX package's ``SpecBuilder``, leaf for leaf, and the port's shards.

The JAX builder reads only ``mesh.shape`` and ``mesh.axis_names``, so a
stand-in object serves as its mesh; the port's is
``launch.mesh.make_production_mesh`` (a shape, no ranks). The JAX trees
stack each pattern position's layers along a leading axis (``lax.scan``)
whose spec entry is None; the port keeps one entry per layer, so each
stacked spec is compared, without that entry, with every layer it
stands for. Also: each rank's shards, put back at their offsets, are the
whole leaf, and the mesh's lines and ranks are laid out as
``jax.make_mesh`` lays out devices."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.launch.sharding import SpecBuilder as JSpecBuilder
from repro.models import get_config as jget_config
from repro_torch.launch.mesh import (Mesh, data_axes_of, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import P, SpecBuilder, _guard, shard
from repro_torch.models.config import get_config
from repro_torch.models.model import init_params
from repro_torch.training import tree

CONFIGS = ["tiny", "tiny-moe", "xlstm-350m-smoke", "recurrentgemma-9b-smoke",
           "gemma2-27b-smoke", "llava-next-34b-smoke", "musicgen-medium-smoke"]
MESHES = [(1, 1), (2, 2), (4, 2), (16, 16)]


class _JaxMesh:
    """What the JAX ``SpecBuilder`` reads of a mesh."""

    def __init__(self, shape, axes=("data", "model")):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _entries(spec):
    return tuple(spec)


def _unstack_spec(spec):
    return tuple(spec)[1:]


def _jax_to_port(cfg, jtree, leaf=lambda s: s):
    """A JAX params-spec tree in the port's layout (layers unstacked)."""
    is_p = lambda x: type(x).__name__ == "PartitionSpec"
    n_pos = len(cfg.pattern)
    out = {k: _entries(jtree[k]) for k in jtree if k not in ("scan", "tail")}
    layers = []
    for r in range(cfg.reps):
        for j in range(n_pos):
            layers.append(jax.tree.map(_unstack_spec, jtree["scan"][j],
                                       is_leaf=is_p))
    for t in jtree["tail"]:
        layers.append(jax.tree.map(_entries, t, is_leaf=is_p))
    out["layers"] = layers
    return out


def _port_entries(t):
    if isinstance(t, P):
        return tuple(t)
    if isinstance(t, dict):
        return {k: _port_entries(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        items = [_port_entries(v) for v in t]
        return type(t)(*items) if hasattr(t, "_fields") else list(items)
    return t


def _as_lists(t):
    """Tuples of specs -> lists, NamedTuples -> plain lists, so two trees
    compare by structure and leaves only."""
    if isinstance(t, dict):
        return {k: _as_lists(v) for k, v in t.items()}
    if isinstance(t, list) or (isinstance(t, tuple)
                               and (hasattr(t, "_fields")
                                    or any(isinstance(v, (tuple, dict,
                                                          list)) for v in t))):
        return [_as_lists(v) for v in t]
    return t


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_cache_specs_match_jax(name, shape, mode):
    cj, ct = jget_config(name), get_config(name)
    jsb = JSpecBuilder(cj, _JaxMesh(shape), mode=mode)
    sb = SpecBuilder(ct, make_production_mesh(data=shape[0],
                                              model=shape[1]), mode=mode)
    want = _jax_to_port(cj, jsb.params())
    got = _port_entries(sb.params())
    assert _as_lists(got) == _as_lists(want)
    # the optimizer's moments follow the params leaf for leaf, in the
    # order the port's optimizer walks them
    opt = sb.opt(sb.params())
    assert tuple(opt.step) == () and len(opt.m) == len(opt.v)
    assert [tuple(s) for s in opt.m] == [
        tuple(s) for s in tree.flatten(sb.params())[0]]
    # caches: the JAX tree stacks the pattern layers too
    jc = jsb.cache(4, 64)
    is_p = lambda x: type(x).__name__ == "PartitionSpec"
    n_pos = len(cj.pattern)
    want_c = [jax.tree.map(_unstack_spec, jc["scan"][j], is_leaf=is_p)
              for _ in range(cj.reps) for j in range(n_pos)]
    want_c += [jax.tree.map(_entries, t, is_leaf=is_p) for t in jc["tail"]]
    assert _as_lists(_port_entries(sb.cache(4, 64))) == _as_lists(want_c)
    assert tuple(sb.batch_spec(2)) == tuple(jsb.batch_spec(2))


def test_multipod_specs_match_jax():
    """(pod, data, model): the batch shards over both data axes."""
    cj, ct = jget_config("tiny-moe"), get_config("tiny-moe")
    jm = _JaxMesh((2, 2, 2), ("pod", "data", "model"))
    jsb = JSpecBuilder(cj, jm, mode="train")
    mesh = make_production_mesh(multi_pod=True, data=2, model=2, pods=2)
    assert data_axes_of(mesh) == ("pod", "data")
    sb = SpecBuilder(ct, mesh, mode="train")
    assert _as_lists(_port_entries(sb.params())) == _as_lists(
        _jax_to_port(cj, jsb.params()))
    assert tuple(sb.batch_spec(1)) == tuple(jsb.batch_spec(1)) == (
        ("pod", "data"), None)


def test_guard_replicates_what_does_not_divide():
    mesh = make_production_mesh(data=4, model=16)
    assert tuple(_guard(P("data", "model"), (8, 24), mesh)) == ("data", None)
    assert tuple(_guard(P(None, "model"), (3, 32), mesh)) == (None, "model")
    assert tuple(_guard(P(("data", "model")), (64,), mesh)) == (
        ("data", "model"),)


def _reassemble(t, spec, mesh):
    """Every rank's shard put back at its offset; also the cover count."""
    out = torch.zeros_like(t)
    seen = torch.zeros(t.shape, dtype=torch.int32)
    axes = mesh.axis_names
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        coords = dict(zip(axes, idx))
        piece = shard(t, spec, mesh, coords)
        sl = [slice(None)] * t.dim()
        for dim, names in enumerate(spec):
            if names is None:
                continue
            ns = names if isinstance(names, tuple) else (names,)
            n, i = 1, 0
            for a in ns:
                n *= mesh.shape[a]
                i = i * mesh.shape[a] + coords[a]
            size = t.shape[dim] // n
            sl[dim] = slice(i * size, (i + 1) * size)
        out[tuple(sl)] = piece
        seen[tuple(sl)] = 1
    return out, seen


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_shards_put_back_are_the_whole_leaf(name, shape, mode):
    cfg = get_config(name)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_production_mesh(data=shape[0], model=shape[1])
    specs = SpecBuilder(cfg, mesh, mode=mode).params(shapes=params)
    leaves, _ = tree.flatten(params)
    spec_leaves, _ = tree.flatten(specs)
    assert len(leaves) == len(spec_leaves)
    sharded = 0
    for t, spec in zip(leaves, spec_leaves):
        back, seen = _reassemble(t, spec, mesh)
        assert torch.equal(back, t) and bool((seen == 1).all())
        sharded += any(e is not None for e in spec)
    assert sharded > 0


def test_mesh_lays_ranks_out_as_jax_make_mesh():
    """Ranks row-major over (data, model); the lines of an axis are the
    ranks that share the other coordinates; an unbound mesh of one rank
    makes identity collectives."""
    mesh = Mesh((2, 4), ("data", "model"), bind=False)
    assert mesh.devices.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh._lines(("model",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh._lines(("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    pod = Mesh((2, 2, 2), ("pod", "data", "model"), bind=False)
    assert pod._lines(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    one = make_host_mesh(1, 1)
    assert one.member and one.coords == {"data": 0, "model": 0}
    x = torch.arange(6.0).reshape(2, 3)
    g = one.model_group
    assert not g.active and g.size == 1
    assert g.all_reduce(x) is x and g.all_gather(x, -1) is x
    with pytest.raises(ValueError, match="world of 2"):
        make_host_mesh(2, 1)
    assert np.array_equal(make_production_mesh().devices.shape, (16, 16))
