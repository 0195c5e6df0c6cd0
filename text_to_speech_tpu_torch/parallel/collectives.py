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
