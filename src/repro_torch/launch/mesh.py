"""Meshes of ranks on ``torch.distributed``: the PyTorch counterpart of
``repro.launch.mesh``.

The JAX package has one controller: a ``jax.sharding.Mesh`` spans its
devices and GSPMD inserts the collectives. The port is SPMD instead: one
process per rank, every rank running the same program on the same
requests. A ``Mesh`` names the ranks of a world laid out as (data,
model) or (pod, data, model), row-major as ``jax.make_mesh`` lays out
devices (rank ``base + d * model + m`` sits at (d, m)), and holds, for
this process, one process group per axis line it belongs to: the
``model`` line (tensor parallelism), each single axis and the data axes
together (the batch's shards). ``AxisGroup`` wraps one such line with
the collectives the model and the decoder call.

The backend is the caller's: ``torch.distributed.init_process_group``
(gloo for CPU tensors, NCCL for CUDA tensors) before the first mesh. A
mesh is made by every rank of the world in the same order (a new group
is a collective of the whole world, members or not); a rank outside the
mesh gets no groups and takes no part in its decodes. Without an
initialised world, a mesh of one rank is unbound: its lines have no
group and every collective is the identity. ``make_production_mesh``
gives the shape of the TPU target only (the spec builder reads nothing
else), never groups; ``Mesh.for_count`` gives the dry run
(``launch.dryrun``) that shape as one rank sees it, each line a
``CountingGroup`` of its true size that tallies the collectives a step
issues instead of running them.

Collectives of a gloo group on CUDA tensors are staged through host
memory explicitly; NCCL takes CUDA tensors as they are (and inside a
CUDA graph capture). Nothing switches backend or device when a
collective fails.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS_NAMES = ("pod", "data")


def _world() -> Tuple[int, int]:
    """(this process's rank, world size): (0, 1) without a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AxisGroup:
    """One mesh line through this rank: ``size`` ranks, this rank at
    ``index`` among them, in mesh order. ``group`` is None for a line of
    one rank of an unbound mesh, where every collective is the
    identity."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = size
        self.index = index
        self.backend = dist.get_backend(group) if group is not None else None

    def __repr__(self):
        return (f"AxisGroup(size={self.size}, index={self.index}, "
                f"backend={self.backend})")

    @property
    def active(self) -> bool:
        return self.group is not None

    def _run(self, fn, *tensors):
        """Call ``fn`` on the tensors, staged through host memory when a
        gloo group gets CUDA tensors; returns them on their device."""
        dev = tensors[0].device
        if self.backend == "gloo" and dev.type == "cuda":
            host = [t.cpu() for t in tensors]
            fn(*host)
            return [h.to(dev) for h in host]
        fn(*tensors)
        return list(tensors)

    def all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """Sum (or ``op``) over the line; a new tensor, the same bits on
        every rank of the line."""
        if self.group is None:
            return x
        out = x.contiguous().clone()
        op = dist.ReduceOp.SUM if op is None else op
        return self._run(lambda t: dist.all_reduce(t, op=op,
                                                   group=self.group), out)[0]

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The line's shards concatenated along ``dim`` in mesh order."""
        if self.group is None:
            return x
        x = x.contiguous()
        out = x.new_empty((self.size,) + tuple(x.shape))

        def gather(o, t):
            if self.backend == "nccl":
                dist.all_gather_into_tensor(o, t, group=self.group)
            else:
                parts = list(o.unbind(0))
                dist.all_gather(parts, t, group=self.group)
        out = self._run(gather, out, x)[0]
        dim = dim % x.dim()
        return out.movedim(0, dim).reshape(
            *x.shape[:dim], self.size * x.shape[dim], *x.shape[dim + 1:])

    def send(self, x: torch.Tensor, to: int) -> None:
        """``x`` to the line's rank ``to`` (blocking)."""
        dst = dist.get_global_rank(self.group, to)
        self._run(lambda t: dist.send(t, dst=dst, group=self.group),
                  x.contiguous())

    def recv(self, buf: torch.Tensor, frm: int) -> torch.Tensor:
        """The tensor the line's rank ``frm`` sends, into ``buf``'s shape
        and dtype; returned on ``buf``'s device."""
        src = dist.get_global_rank(self.group, frm)
        return self._run(lambda t: dist.recv(t, src=src, group=self.group),
                         buf)[0]

    def broadcast(self, x: torch.Tensor, frm: int) -> torch.Tensor:
        """The line's rank ``frm``'s ``x`` on every rank of the line."""
        if self.group is None:
            return x
        src = dist.get_global_rank(self.group, frm)
        return self._run(lambda t: dist.broadcast(t, src=src,
                                                  group=self.group),
                         x.contiguous())[0]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block ``i`` of dim 0 goes to the line's rank ``i``; block ``j``
        of the result came from rank ``j`` (``lax.all_to_all`` with
        ``tiled=True`` over dim 0)."""
        if self.group is None:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        return self._run(lambda o, t: dist.all_to_all_single(
            o, t, group=self.group), out, x)[0]


class _Counted(torch.autograd.Function):
    """A counting line's collective: a tensor of the result's shape (no
    values move), its kind and bytes added to the tally; under autograd
    the backward adds the adjoint collective (``CountingGroup``)."""

    @staticmethod
    def forward(ctx, x, group, kind, back, shape):
        ctx.group, ctx.back, ctx.shape = group, back, x.shape
        out = x.new_empty(shape)
        group.note(kind, out)
        return out

    @staticmethod
    def backward(ctx, g):
        grad = g.new_empty(ctx.shape)
        ctx.group.note(ctx.back, grad)
        return grad, None, None, None, None


class CountingGroup(AxisGroup):
    """A mesh line of ``size`` ranks in a count of one rank's step
    (``launch.dryrun``): no process group behind it. Each collective
    returns a tensor of its result's shape, whose values are not the
    line's (a count reads shapes only), and adds ``(kind, result bytes,
    line size)`` to ``tally``, as the reference's dry run sums the result
    shapes of the collectives in its compiled program. Under autograd a
    collective's backward adds its adjoint: all_reduce's an all_reduce,
    all_gather's a reduce_scatter, all_to_all's an all_to_all,
    broadcast's a reduce. A line of one rank moves nothing: its
    collectives are the identity, as on an unbound mesh."""

    ADJOINT = {"all_reduce": "all_reduce", "all_gather": "reduce_scatter",
               "all_to_all": "all_to_all", "broadcast": "reduce"}

    def __init__(self, size: int, index: int, tally: list):
        super().__init__(None, size, index)
        self.tally = tally

    def __repr__(self):
        return f"CountingGroup(size={self.size}, index={self.index})"

    def note(self, kind: str, t: torch.Tensor) -> None:
        self.tally.append((kind, t.numel() * t.element_size(), self.size))

    def _count(self, kind, x, shape=None):
        if self.size == 1:
            return x
        shape = tuple(x.shape) if shape is None else shape
        return _Counted.apply(x, self, kind, self.ADJOINT[kind], shape)

    def all_reduce(self, x, op=None):
        return self._count("all_reduce", x)

    def all_gather(self, x, dim: int = 0):
        dim = dim % x.dim()
        shape = list(x.shape)
        shape[dim] *= self.size
        return self._count("all_gather", x, tuple(shape))

    def all_to_all(self, x):
        return self._count("all_to_all", x)

    def broadcast(self, x, frm: int):
        return self._count("broadcast", x)

    def send(self, x, to: int) -> None:
        self.note("send", x)

    def recv(self, buf, frm: int):
        self.note("recv", buf)
        return buf.new_empty(buf.shape)


class Mesh:
    """Ranks ``base .. base + prod(shape) - 1`` laid out over
    ``axis_names``. ``shape`` maps each axis to its extent (as
    ``jax.sharding.Mesh.shape``); ``devices`` is the array of rank ids.
    ``bind=False`` keeps the shape only (no groups, any size)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 base: int = 0, bind: bool = True):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values())))
        self.devices = np.arange(base, base + self.size).reshape(
            tuple(self.shape.values()))
        self.rank, world = _world()
        self.bound = bind
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}
        if not bind:
            return
        if base + self.size > world and not (world == 1 and self.size == 1
                                             and base == 0):
            raise ValueError(
                f"a mesh of {self.size} ranks from rank {base} needs a "
                f"torch.distributed world of {base + self.size} ranks "
                f"(world: {world}; initialise it first)")
        for axes in self._line_kinds():
            self._groups[axes] = self._make_group(axes)

    # ------------------------------------------------------ identity

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return bool((self.devices == self.rank).any())

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        where = np.argwhere(self.devices == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return data_axes_of(self)

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks {int(self.devices.min())}.."
                f"{int(self.devices.max())})")

    # ------------------------------------------------------ groups

    def _line_kinds(self):
        kinds = [(a,) for a in self.axis_names]
        data = self.data_axes
        if len(data) > 1:
            kinds.append(data)
        return kinds

    def _lines(self, axes: Tuple[str, ...]):
        """Every line along ``axes`` (the ranks that share the other
        axes' coordinates), each in mesh order."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        arr = self.devices.transpose(rest + keep)
        n = int(np.prod([self.devices.shape[i] for i in keep]))
        return [list(map(int, line)) for line in arr.reshape(-1, n)]

    def _make_group(self, axes) -> Optional[AxisGroup]:
        lines = self._lines(axes)
        mine = None
        for line in lines:
            # a new group is a collective of the whole world, members or
            # not; a world of one rank makes them too (NCCL's one-rank
            # communicator is what a CUDA graph then captures)
            g = dist.new_group(line) if dist.is_initialized() else None
            if self.rank in line:
                mine = AxisGroup(g, len(line), line.index(self.rank))
        return mine

    def group(self, axes) -> AxisGroup:
        """This rank's line along ``axes`` (a name or a tuple of names;
        the empty tuple is a line of one)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes:
            return AxisGroup(None, 1, 0)
        if len(axes) == 1 and axes[0] not in self.shape:
            return AxisGroup(None, 1, 0)
        g = self._groups.get(axes)
        if g is None:
            if not self.bound:
                raise ValueError(f"{self} has its shape only: no groups")
            if not self.member:
                raise ValueError(f"rank {self.rank} is not in {self}")
            raise KeyError(axes)
        return g

    def for_count(self, coords: Optional[Dict[str, int]] = None
                  ) -> "Mesh":
        """This mesh's shape as seen by the rank at ``coords`` (each axis's
        index, 0 where not named) in a count of its step: every line a
        ``CountingGroup`` of its true size, all adding to one ``tally``
        (a list of (kind, bytes, line size)), no process group."""
        m = Mesh(tuple(self.shape.values()), self.axis_names, bind=False)
        at = {a: 0 for a in self.axis_names}
        at.update(coords or {})
        m.rank = int(self.devices[tuple(at[a] for a in self.axis_names)])
        m.tally = []
        for axes in m._line_kinds():
            line = next(ln for ln in m._lines(axes) if m.rank in ln)
            m._groups[axes] = CountingGroup(len(line), line.index(m.rank),
                                            m.tally)
        return m

    @property
    def model_group(self) -> AxisGroup:
        return self.group("model")

    @property
    def data_group(self) -> AxisGroup:
        return self.group(self.data_axes)


def make_production_mesh(*, multi_pod: bool = False, data: int = 16,
                         model: int = 16, pods: int = 2) -> Mesh:
    """(data, model) = (16, 16) per pod; multi_pod prepends pods=2. The
    shape only: the spec builder reads ``shape`` and ``axis_names``."""
    shape = (pods, data, model) if multi_pod else (data, model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, bind=False)


def make_host_mesh(data: int = 1, model: int = 1, base: int = 0) -> Mesh:
    """A (data, model) mesh over ranks ``base ..`` of the current world
    (every rank of the world calls it)."""
    return Mesh((data, model), ("data", "model"), base=base)


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DATA_AXIS_NAMES)


def make_submeshes(n: int, data: int = 1, model: int = 1) -> list:
    """Split the world into ``n`` disjoint (data, model) meshes over
    consecutive rank ranges, one per serving engine (every rank of the
    world calls it; each rank serves on the one it belongs to)."""
    _, world = _world()
    per = data * model
    if world < n * per:
        raise ValueError(f"need {n} x {data}x{model} = {n * per} ranks, "
                         f"have {world}")
    return [make_host_mesh(data, model, base=i * per) for i in range(n)]

