"""The collectives of the port's mesh, written out.

The JAX package never writes a collective: XLA inserts them from the
shardings.  The port runs one process per device (`parallel.Mesh`), so
every reduction that crosses ranks is a call here, on a process group of
the mesh:

  - `all_reduce_`, `broadcast_`, `all_gather`, `send` / `recv`: tensor
    collectives, called on the tensor as it is, except that `send` /
    `recv` stage a CUDA tensor through host memory on a gloo group
    (`stages_through_host`): gloo's point-to-point calls hand the tensor's
    pointer to its transport and have no device copy of their own
    (``chip_smoke.py --probe-gloo-p2p`` shows it on a card);
  - `all_reduce_sum`: the differentiable all-reduce (its backward is the
    all-reduce of the gradient), which keeps a statistic over the whole
    batch differentiable when each rank holds some of the rows;
  - `average_gradients`: the data-parallel gradient reduce, one flat
    buffer for each dtype;
  - `broadcast_object` / `all_gather_objects`: host values (pickled), for
    the serving controller and the results it gathers.

`tensor_shard` marks a region in which the arches split their layers over
the mesh's ``tp`` axis and WaveGlow's `infer` its time axis over ``sp``;
`tensor_axis` gives them the axis (its group, this rank's index along
it, its size and ranks).  The tensor-parallel operators are autograd
functions under Megatron's convention, in which a tensor every rank of
the axis holds whole (replicated) carries the whole gradient on every
rank:

  - `tp_enter` (Megatron's *f*): identity forward, the gradient
    all-reduced backward, where a replicated tensor enters layers whose
    weights are sharded (each rank's gradient is its shard's part);
  - `tp_exit` (*g*): the partial sums all-reduced forward, the gradient
    passed through backward.  Not `all_reduce_sum`, whose backward
    all-reduces the gradient too: behind an exit every rank computes the
    same loss, so that would give the sharded weights the axis's size
    times their gradient;
  - `tp_split` / `tp_all_gather`: a replicated tensor's slice of this
    rank along a dimension (backward: the slices gathered) and the
    slices gathered (backward: the rank's slice of the gradient);
  - `tp_reduce_scatter`: partial sums summed and scattered along a
    dimension (backward: the gradient gathered);
  - `halo_exchange`: a shard along a dimension extended by its
    neighbours' edge rows over send / recv, zeros past the two ends
    (backward: the halo's gradient sent back and added).

`batch_shard` marks a region in which the current rank holds shard
``index`` of ``n`` equal shards of a batch spread over a group: inside it
`batch_sum` all-reduces (sums and counts of masked means, batch-norm
statistics), `batch_gather` gathers the rows of a loss that compares
every row with every other (GE2E), and `batch_draw` draws the random
tensor of the whole batch and keeps the rank's rows, so that a sharded
step sees the draws one process makes for the whole batch.  Outside it
all three are the plain local operations.
"""

import contextlib
import threading

import torch
import torch.distributed as dist

_SHARD = threading.local()


def _backend(group):
    return dist.get_backend(group)


def stages_through_host(tensor, group = None):
    """True when `send` / `recv` move `tensor` over `group` through host
    memory: a CUDA tensor on a gloo group."""
    return tensor.is_cuda and _backend(group) == dist.Backend.GLOO


def _group_size(group):
    return dist.get_world_size(group) if group is not None else dist.get_world_size()


def all_reduce_(tensor, group = None, op = dist.ReduceOp.SUM):
    """In-place all-reduce of `tensor` over `group`; returns it."""
    if group is not None and _group_size(group) == 1:
        return tensor
    dist.all_reduce(tensor, op = op, group = group)
    return tensor


def broadcast_(tensor, src, group = None):
    """In-place broadcast of `tensor` from the global rank `src`."""
    if group is not None and _group_size(group) == 1:
        return tensor
    dist.broadcast(tensor, src, group = group)
    return tensor


def all_gather(tensor, group = None):
    """The `tensor` of every rank of `group`, in group-rank order."""
    n = _group_size(group)
    if n == 1:
        return [tensor]
    tensor = tensor.contiguous()
    out = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(out, tensor, group = group)
    return out


def send(tensor, dst, group = None):
    """Blocking send of `tensor` to the global rank `dst`."""
    dist.send(tensor.cpu() if stages_through_host(tensor, group) else tensor.contiguous(),
              dst, group = group)


def recv(shape, dtype, device, src, group = None):
    """A new tensor received from the global rank `src`."""
    out = torch.empty(shape, dtype = dtype, device = device)
    if stages_through_host(out, group):
        host = torch.empty(shape, dtype = dtype)
        dist.recv(host, src, group = group)
        return host.to(device)
    dist.recv(out, src, group = group)
    return out


def broadcast_object(obj, src = 0, group = None):
    """`obj` of the global rank `src` on every rank of `group`."""
    box = [obj]
    dist.broadcast_object_list(box, src = src, group = group)
    return box[0]


def all_gather_objects(obj, group = None):
    """Every rank's `obj`, in group-rank order."""
    out = [None] * _group_size(group)
    dist.all_gather_object(out, obj, group = group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return all_reduce_(tensor.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None


def all_reduce_sum(tensor, group = None):
    """The sum of `tensor` over `group`, differentiable: each rank's
    gradient is the sum of every rank's gradient of the result, so that the
    gradients all ranks compute, summed, are those of the whole batch."""
    if group is not None and _group_size(group) == 1:
        return tensor
    return _AllReduceSum.apply(tensor, group)


def average_gradients(tensors, group = None, *, average = True):
    """All-reduce the ``.grad`` of `tensors` over `group` (a missing one
    counts as zeros) and divide by the group's size (`average`), one flat
    buffer for each dtype."""
    n = _group_size(group)
    if n == 1:
        return
    by_dtype = {}
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        by_dtype.setdefault(t.grad.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.grad.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        if average:
            flat.div_(n)
        offset = 0
        for t in ts:
            k = t.grad.numel()
            t.grad.copy_(flat[offset: offset + k].view_as(t.grad))
            offset += k


# -- the rows of a batch spread over a group ------------------------------------------

@contextlib.contextmanager
def batch_shard(group, index, n):
    """Inside the block this rank holds the rows of shard `index` of `n`
    of every batch, the shards spread over `group`."""
    previous = getattr(_SHARD, 'value', None)
    _SHARD.value = (group, index, n)
    try:
        yield
    finally:
        _SHARD.value = previous


def current_shard():
    """(group, index, n) of the enclosing `batch_shard`, or None."""
    return getattr(_SHARD, 'value', None)


def batch_sum(tensor):
    """`tensor` summed over the ranks of the enclosing `batch_shard`
    (differentiable); the tensor itself outside one."""
    shard = current_shard()
    if shard is None or shard[2] == 1:
        return tensor
    return all_reduce_sum(tensor, shard[0])


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group, index):
        ctx.group, ctx.index, ctx.rows = group, index, tensor.shape[0]
        return torch.cat(all_gather(tensor.contiguous(), group), dim = 0)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return grad[ctx.index * ctx.rows: (ctx.index + 1) * ctx.rows], None, None


def batch_gather(tensor):
    """The rows of every rank of the enclosing `batch_shard`, in shard order
    (differentiable: each rank's gradient of its rows is the sum of every
    rank's); the tensor itself outside one."""
    shard = current_shard()
    if shard is None or shard[2] == 1:
        return tensor
    return _AllGatherRows.apply(tensor, shard[0], shard[1])


def batch_draw(draw, shape, ** kwargs):
    """``draw(shape, ** kwargs)`` (`torch.rand`, `torch.randn`) for a
    batch-leading `shape`: inside a `batch_shard` the draw of the whole
    batch (n × the rows), of which this rank keeps its own, so that the
    generator advances as in one process."""
    shard = current_shard()
    if shard is None or shard[2] == 1:
        return draw(shape, ** kwargs)
    _, index, n = shard
    rows = shape[0]
    full = draw((rows * n,) + tuple(shape[1:]), ** kwargs)
    return full[index * rows: (index + 1) * rows]


# -- tensor and sequence parallelism ---------------------------------------------------

_TENSOR = threading.local()


class Axis:
    """A mesh axis as the tensor-parallel operators use it: its process
    ``group``, this rank's ``index`` along it, its ``size`` and its global
    ``ranks`` in axis order (a group's ranks are sorted, and the mesh's
    ids grow along every axis, so the index is the group rank)."""

    def __init__(self, group, index, size, ranks):
        self.group, self.index, self.size, self.ranks = group, int(index), int(size), list(ranks)

    @classmethod
    def of(cls, mesh, name):
        """The axis `name` of `mesh` (a `parallel.Mesh` with its groups)."""
        return cls(mesh.group(name), mesh.coords[name], mesh.shape[name],
                   mesh.group_ranks(name))

    def __repr__(self):
        return 'Axis(index={}, size={})'.format(self.index, self.size)


@contextlib.contextmanager
def tensor_shard(mesh):
    """Inside the block the arches split their layers over the axis ``tp``
    of `mesh` (their parameters sharded by the spec trees of `parallel`)
    and WaveGlow's `infer` its time axis over ``sp``; an axis the mesh
    lacks, or of size 1, leaves them whole."""
    previous = getattr(_TENSOR, 'value', None)
    axes = {}
    for name in ('tp', 'sp'):
        if mesh.shape.get(name, 1) > 1:
            axes[name] = Axis.of(mesh, name)
    _TENSOR.value = axes
    try:
        yield
    finally:
        _TENSOR.value = previous


def tensor_axis(role = 'tp'):
    """The `Axis` of the enclosing `tensor_shard` for `role` ('tp' or 'sp'),
    or None."""
    value = getattr(_TENSOR, 'value', None)
    return value.get(role) if value else None


def _split(x, dim, axis):
    size = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * size, size).contiguous()


def _gather(x, dim, axis):
    return torch.cat(all_gather(x.contiguous(), axis.group), dim = dim)


def _reduce_scatter(x, dim, axis):
    if x.shape[dim] % axis.size:
        raise ValueError('dimension {} of size {} does not divide over {} ranks'.format(
            dim, x.shape[dim], axis.size))
    if _backend(axis.group) == dist.Backend.NCCL:
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // axis.size,) + tuple(moved.shape[1:]),
                          dtype = x.dtype, device = x.device)
        dist.reduce_scatter_tensor(out, moved, group = axis.group)
        return out.movedim(0, dim).contiguous()
    # gloo: the sum whole, then the rank's part
    return _split(all_reduce_(x.contiguous().clone(), axis.group), dim, axis)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.axis.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _split(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _split(grad, ctx.dim, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.axis), None, None


def _dim(x, dim):
    return dim % x.dim()


def tp_enter(x, axis):
    """Megatron's *f*: `x` as it is; backward, its gradient all-reduced
    over `axis` (an `Axis`; None: the identity)."""
    return x if axis is None else _Enter.apply(x, axis)


def tp_exit(x, axis):
    """Megatron's *g*: the partial sums `x` all-reduced over `axis`;
    backward, the gradient as it is (the identity without an axis)."""
    return x if axis is None else _Exit.apply(x, axis)


def tp_split(x, dim, axis):
    """This rank's slice of the replicated `x` along `dim` (equal slices in
    axis order); backward, the slices' gradients gathered."""
    return x if axis is None else _Split.apply(x, _dim(x, dim), axis)


def tp_all_gather(x, dim, axis):
    """The ranks' slices `x` concatenated along `dim` in axis order;
    backward, this rank's slice of the gradient."""
    return x if axis is None else _AllGather.apply(x, _dim(x, dim), axis)


def tp_reduce_scatter(x, dim, axis):
    """The partial sums `x` summed over `axis`, and this rank's slice of
    the sum along `dim`; backward, the gradient gathered."""
    return x if axis is None else _ReduceScatter.apply(x, _dim(x, dim), axis)


def _neighbour_exchange(to_prev, to_next, axis):
    """Send `to_prev` to the previous rank of `axis` and `to_next` to the
    next; → (what the previous rank sent, what the next one sent), zeros
    where there is no neighbour.  The sends and receives go in one
    `batch_isend_irecv`, which NCCL runs as one group: posted one by one,
    both ranks of a pair would queue their sends before their receives,
    and a send larger than NCCL's buffer would wait on a receive queued
    behind the peer's own send.  A CUDA tensor on a gloo group travels
    through host memory (`stages_through_host`)."""
    group, i, ranks = axis.group, axis.index, axis.ranks
    staged = stages_through_host(to_prev, group)
    device = to_prev.device
    move = (lambda t: t.cpu()) if staged else (lambda t: t.contiguous())
    from_prev = torch.zeros_like(to_next, device = 'cpu' if staged else device)
    from_next = torch.zeros_like(to_prev, device = 'cpu' if staged else device)
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, move(to_prev), ranks[i - 1], group),
                dist.P2POp(dist.irecv, from_prev, ranks[i - 1], group)]
    if i < axis.size - 1:
        ops += [dist.P2POp(dist.isend, move(to_next), ranks[i + 1], group),
                dist.P2POp(dist.irecv, from_next, ranks[i + 1], group)]
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return from_prev.to(device), from_next.to(device)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, width, dim, axis):
        ctx.width, ctx.dim, ctx.axis = width, dim, axis
        if x.shape[dim] < width:
            raise ValueError('a halo of {} rows wider than the shard of {}'.format(
                width, x.shape[dim]))
        left, right = _neighbour_exchange(x.narrow(dim, 0, width),
                                          x.narrow(dim, x.shape[dim] - width, width), axis)
        return torch.cat([left, x, right], dim = dim)

    @staticmethod
    def backward(ctx, grad):
        width, dim = ctx.width, ctx.dim
        n = grad.shape[dim] - 2 * width
        to_prev, core = grad.narrow(dim, 0, width), grad.narrow(dim, width, n).clone()
        to_next = grad.narrow(dim, width + n, width)
        from_prev, from_next = _neighbour_exchange(to_prev, to_next, ctx.axis)
        # the previous rank's right halo is this rank's first rows, the
        # next rank's left halo its last ones
        core.narrow(dim, 0, width).add_(from_prev)
        core.narrow(dim, n - width, width).add_(from_next)
        return core, None, None, None


def halo_exchange(x, width, dim, axis):
    """`x`, this rank's shard along `dim`, extended by `width` rows of each
    neighbour along `axis`: the previous rank's last rows before, the next
    rank's first rows after, zeros past the two ends.  Differentiable: a
    halo row's gradient goes back to the rank that owns the row."""
    if axis is None or width == 0:
        return x
    return _Halo.apply(x, int(width), _dim(x, dim), axis)
