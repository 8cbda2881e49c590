"""The collectives and parameter placement behind `sharding.constrain` on a
training mesh: every rank holds plain local tensors, and what GSPMD
inserts is written out here.

Gradients follow one convention: the gradient a rank holds of a tensor it
holds whole (replicated over some mesh axes) is a *partial* sum, and the
true gradient is the sum over the ranks that hold it.  Then every
collective's backward is its adjoint:

  all_gather      forward all-gather along a dim; backward reduce-scatter
  reduce_scatter  forward reduce-scatter; backward all-gather
  all_reduce      forward sum; backward sum
  slicing         forward narrow; backward pad with zeros (autograd's own)

so a loss that every rank computes whole is backpropagated from 1 / N on
each of the N ranks (`trainer.train_step`), and what reaches a parameter
is a partial sum over the ranks that use it: `reduce_grads` completes it.

Parameters (`param_sharding.assign_param_shardings`) carry their layout
as `placement(p)`: for each dim the mesh axes it is split over, or None.
`full(p)` all-gathers a parameter where it is used (a layer at a time
under FSDP, and again in the rematerialised backward), `local_block(p,
dim, lo, hi)` returns a block of it without gathering along `dim` when
that block is the one the rank holds (a column- or row-parallel
product).  Both are differentiable, their backward the reduce-scatter
that lands each gradient on the rank holding its block.

gloo is the backend for ranks on the CPU and for ranks sharing one card.
It has no reduce-scatter for CUDA tensors, so there the reduce-scatter is
an all-reduce followed by this rank's block (twice the bytes).

Each collective records the bytes of its result with the roofline
counter (`roofline.analysis.record_collective`): the reference's
convention, and what the dry run's collective term reads.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import active_mesh, gather_ranks
from repro_torch.roofline.analysis import collective


def _mesh():
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("a mesh collective needs active rules "
                           "(sharding.use_rules)")
    return mesh


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of `group`'s n ranks concatenated along `dim`."""
    out = gather_ranks(x, n, group)  # [n, *x.shape]
    return out.movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int,
                    k: int) -> torch.Tensor:
    """Block k of the sum over `group` of x, along `dim`."""
    size = x.shape[dim] // n
    nbytes = x.numel() // n * x.element_size()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        total = x.contiguous().clone()
        with collective("reduce-scatter", nbytes):
            dist.all_reduce(total, group=group)
        return total.narrow(dim, k * size, size).contiguous()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((size,) + tuple(src.shape[1:]))
    with collective("reduce-scatter", nbytes):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of x over `group` (a 0-d x travels as [1])."""
    out = x.reshape(-1).clone()
    with collective("all-reduce", out.numel() * out.element_size()):
        dist.all_reduce(out, group=group)
    return out.view(x.shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        mesh = _mesh()
        ctx.dim, ctx.axes = dim, axes
        ctx.mesh = mesh
        return _gather(x.contiguous(), dim, mesh.group(axes),
                       mesh.size(axes))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return (_reduce_scatter(g, ctx.dim, mesh.group(ctx.axes),
                                mesh.size(ctx.axes), mesh.index(ctx.axes)),
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        mesh = _mesh()
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return _reduce_scatter(x, dim, mesh.group(axes), mesh.size(axes),
                               mesh.index(axes))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return (_gather(g.contiguous(), ctx.dim, mesh.group(ctx.axes),
                        mesh.size(ctx.axes)), None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        mesh = _mesh()
        ctx.axes, ctx.mesh = axes, mesh
        return _sum(x, mesh.group(axes))

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh.group(ctx.axes)), None


def _one(axes) -> bool:
    """Whether mesh `axes` hold one rank (None: no axes, as without a
    mesh): a collective over them is the identity."""
    return not axes or _mesh().size(axes) == 1


def all_gather(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """x's blocks of the ranks along mesh `axes`, concatenated along dim."""
    if _one(axes):
        return x
    return _AllGather.apply(x, dim, tuple(axes))


def reduce_scatter(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block along dim of the sum of x over mesh `axes`."""
    if _one(axes):
        return x
    return _ReduceScatter.apply(x, dim, tuple(axes))


def all_reduce(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of x over mesh `axes`."""
    if _one(axes):
        return x
    return _AllReduce.apply(x, tuple(axes))


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max of x over mesh `axes` (no gradient)."""
    if _one(axes):
        return x.detach()
    out = x.detach().contiguous().clone()
    with collective("all-reduce", out.numel() * out.element_size()):
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=_mesh().group(axes))
    return out


def axes_size(axes) -> int:
    """The number of ranks along mesh `axes` of the active mesh."""
    return _mesh().size(axes) if axes else 1


def rank_range(n: int, axes) -> tuple[int, int]:
    """[lo, hi): this rank's block of an axis of n split over mesh `axes`
    (None: the whole axis)."""
    if not axes:
        return 0, n
    mesh = _mesh()
    size = n // mesh.size(axes)
    return mesh.index(axes) * size, (mesh.index(axes) + 1) * size


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def placement(t: torch.Tensor):
    """The layout a tensor was placed at (a tuple per dim: None or the mesh
    axes it is split over), or None for a tensor held whole."""
    return getattr(t, "_mesh_spec", None)


def set_placement(t: torch.Tensor, spec) -> torch.Tensor:
    t._mesh_spec = tuple(spec)
    return t


def _split_dims(p):
    spec = placement(p)
    return [] if spec is None else [(d, a) for d, a in enumerate(spec) if a]


def full(p: torch.Tensor, *, keep: int | None = None) -> torch.Tensor:
    """The whole parameter (all-gathered along every split dim but `keep`);
    p itself when it is held whole or no mesh is active."""
    if active_mesh() is None:
        return p
    x = p
    for dim, axes in _split_dims(p):
        if dim != keep:
            x = all_gather(x, dim, axes)
    return x


def local_block(p: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """p[lo:hi] along `dim` of the whole parameter, gathered along every
    other split dim; along `dim` nothing is gathered when [lo, hi) is the
    block this rank holds, and nothing is sliced when it is the whole dim
    (a slice's backward writes a zeroed gradient of the whole)."""
    spec = placement(p)
    axes = spec[dim] if spec is not None else None
    if axes:
        mesh = _mesh()
        n = p.shape[dim]
        if (lo, hi) == (mesh.index(axes) * n, (mesh.index(axes) + 1) * n):
            return full(p, keep=dim)
    x = full(p)
    if (lo, hi) == (0, x.shape[dim]):
        return x
    return x.narrow(dim, lo, hi - lo)


def replicated_axes(mesh, spec) -> tuple:
    """The mesh axes over which a tensor at layout `spec` is replicated."""
    used = {a for axes in (spec or ()) if axes for a in axes}
    return tuple(a for a in mesh.axis_names if a not in used)


def split_axes(mesh, spec) -> tuple:
    """The mesh axes a tensor at layout `spec` is split over."""
    used = {a for axes in (spec or ()) if axes for a in axes}
    return tuple(a for a in mesh.axis_names if a in used)


BUCKET = 1 << 26  # elements an all-reduce of gradients carries at most


@torch.no_grad()
def reduce_grads(grads: list[torch.Tensor], specs: list, mesh) -> None:
    """Complete, in place, each parameter's partial gradient (`grads`, at
    the parameters' layouts `specs`): the sum over the mesh axes along
    which the parameter is replicated.  Grads of one set of axes and one
    dtype are flattened into buckets of at most BUCKET elements, one
    all-reduce a bucket, in parameter order."""
    groups: dict[tuple, list] = {}
    for g, spec in zip(grads, specs):
        axes = replicated_axes(mesh, spec)
        if axes and mesh.size(axes) > 1:
            groups.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), members in groups.items():
        start = 0
        while start < len(members):
            end, n = start, 0
            while end < len(members) and (
                    end == start or n + members[end].numel() <= BUCKET):
                n += members[end].numel()
                end += 1
            bucket = members[start:end]
            flat = torch.cat([g.reshape(-1) for g in bucket])
            with collective("all-reduce",
                            flat.numel() * flat.element_size()):
                dist.all_reduce(flat, group=mesh.group(axes))
            for g, piece in zip(bucket, flat.split(
                    [g.numel() for g in bucket])):
                g.copy_(piece.view_as(g))
            start = end


def global_norm(sums: torch.Tensor, specs: list, mesh) -> torch.Tensor:
    """The fp32 L2 norm of the whole tensors whose local blocks, at layouts
    `specs`, have the sums of squares `sums` (fp32 [N], one entry a block):
    each block's entry summed over the ranks that hold the tensor's other
    blocks, so a block held by several ranks counts once."""
    by_axes: dict[tuple, list] = {}
    for i, spec in enumerate(specs):
        by_axes.setdefault(split_axes(mesh, spec), []).append(sums[i])
    total = None
    for axes, parts in by_axes.items():
        s = torch.sum(torch.stack(parts)).reshape(1)
        if axes and mesh.size(axes) > 1:
            with collective("all-reduce", s.numel() * s.element_size()):
                dist.all_reduce(s, group=mesh.group(axes))
        total = s if total is None else total + s
    return torch.sqrt(total)[0]
