"""Device mesh and sharding helpers on `torch.distributed`.

Counterpart of ``text_to_speech_tpu/parallel/__init__.py``.  The JAX mesh
has one controller: one program over many devices, whose collectives XLA
inserts.  The port's mesh is PyTorch's model: **one process per device**,
every rank running the same code on its own shard, with a process group
for each mesh axis (and one for the data axes together) and the
collectives written out (`parallel.collectives`).

Axes, as in the JAX package:

  - ``dp``: data parallel, the batch's leading axis sharded;
  - ``dcn``: data parallel across slices (`create_hybrid_mesh`), the
    outermost axis: the data axes are ``('dcn', 'dp')``;
  - ``pp``: the WaveGlow flow pipeline (`parallel.pipeline`);
  - ``ep``: the experts of a mixture-of-experts FFN (`moe_param_specs`);
  - ``tp``: tensor parallelism, the layers' channels or heads split by the
    spec trees (`waveglow_param_specs`, `fastspeech2_param_specs`,
    `vits_param_specs`, `tacotron2_param_specs`) and the collectives of
    `collectives.tp_enter` / `tp_exit` / ... inside
    `collectives.tensor_shard(mesh)`;
  - ``sp``: WaveGlow's `infer` with the time axis split, each rank's shard
    extended by halos (`collectives.halo_exchange`), in the same context;
    any other axis leaves the paths replicated over it.

A mesh device is a rank (`RankDevice`: its global rank ``id`` and its
`torch.device`).  On a card the backend is NCCL and a rank's device is
``cuda:<local rank>``; NCCL takes one rank a card, so a mesh that asks it
for more ranks than there are cards raises.  The tests run gloo on the CPU.
The backend is always the caller's choice, never a fallback.

`spawn` starts N local processes, one rank each, with a file-store
rendezvous in a temporary directory.  Without a process group a mesh is a
layout only (`create_mesh(devices=[0, 1, ...])`): its helpers slice for its
``rank``, its collectives raise.
"""

import collections
import datetime
import os
import pickle
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from . import collectives

#: this process's device, set by `spawn`'s children (`init_process`)
_PROCESS = {'device': None}


class RankDevice:
    """One rank of the mesh: its global rank ``id`` and its `torch.device`."""

    def __init__(self, id, device):
        self.id = int(id)
        self.device = torch.device(device)

    def __repr__(self):
        return 'RankDevice(id={}, device={})'.format(self.id, self.device)


class PartitionSpec(tuple):
    """A leaf's sharding: one mesh axis name (or None) for each of its
    leading dimensions; ``PartitionSpec()`` is replicated."""

    def __new__(cls, * axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return 'PartitionSpec{}'.format(tuple(self))


P = PartitionSpec


def _rank_device(rank, platform):
    if platform == 'cuda':
        count = torch.cuda.device_count()
        return torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)) % max(count, 1))
    return torch.device('cpu')


def _platform(platform):
    if platform in ('gpu', 'cuda'):
        return 'cuda'
    if platform == 'cpu':
        return 'cpu'
    if platform is not None:
        raise ValueError('unknown platform {!r}: "gpu" (cuda) or "cpu"'.format(platform))
    if _PROCESS['device'] is not None:
        return _PROCESS['device'].type
    if dist.is_initialized() and dist.get_backend() == dist.Backend.NCCL:
        return 'cuda'
    return 'cuda' if torch.cuda.is_available() else 'cpu'


def get_devices(platform = None, count = None):
    """The mesh devices of this job: one `RankDevice` for each rank of the
    process group (a job of one rank without one).  `platform` ('gpu' /
    'cpu') names their device type, by default this process's."""
    platform = _platform(platform)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mine = _PROCESS['device']
    if mine is not None and mine.type != platform:
        mine = None
    devices = [RankDevice(r, mine if mine is not None and r == _this_rank()
                          else _rank_device(r, platform)) for r in range(world)]
    if count is not None:
        if len(devices) < count:
            raise ValueError('Requested {} devices, have {}'.format(count, len(devices)))
        devices = devices[:count]
    return devices


def _this_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def _as_devices(devices, platform):
    if devices is None:
        return get_devices(platform)
    out = []
    for d in devices:
        out.append(d if isinstance(d, RankDevice) else RankDevice(int(d), _rank_device(
            int(d), _platform(platform))))
    return out


class Mesh:
    """The ranks of a job laid out on named axes.

    ``shape`` (an ordered dict of axis sizes), ``axis_names``, ``devices``
    (an array of `RankDevice` of that shape), this process's ``rank``, its
    ``coords`` (axis → index) and ``device``.  When a process group spans
    exactly the mesh's ranks, the mesh holds a group for each axis and one
    for its data axes together (`group`); every rank must build the same
    meshes in the same order, as `torch.distributed.new_group` requires."""

    def __init__(self, devices, axis_names, *, rank = None):
        self.devices = np.asarray(devices, dtype = object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError('devices of shape {} for axes {}'.format(
                self.devices.shape, self.axis_names))
        self.shape = collections.OrderedDict(zip(self.axis_names, self.devices.shape))
        self._ids = np.vectorize(lambda d: d.id, otypes = [np.int64])(self.devices)
        self.rank = _this_rank() if rank is None else int(rank)
        where = np.argwhere(self._ids == self.rank)
        if len(where) != 1:
            raise ValueError('rank {} is not in the mesh {}'.format(self.rank, self._ids.tolist()))
        self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        mine = self.devices[tuple(where[0])]
        self.device = _PROCESS['device'] if _PROCESS['device'] is not None and \
            rank is None else mine.device
        self._groups = {}
        if dist.is_initialized() and self._ids.size == dist.get_world_size():
            self._make_groups()

    @property
    def size(self):
        return int(self._ids.size)

    @property
    def first_rank(self):
        """The global rank of the mesh's first device: the one whose
        weights `shard_params` sends, that writes a run's files, and that
        drives a mesh stepper."""
        return int(self._ids.reshape(-1)[0])

    def _make_groups(self):
        keys = [(a,) for a in self.axis_names]
        data = data_axes(self)
        if len(data) > 1:
            keys.append(data)
        for key in keys:
            axes = [self.axis_names.index(a) for a in key]
            rest = [i for i in range(len(self.axis_names)) if i not in axes]
            moved = np.transpose(self._ids, rest + axes).reshape(-1, int(np.prod(
                [self._ids.shape[i] for i in axes])))
            for ranks in moved:
                group = dist.new_group([int(r) for r in ranks])
                if self.rank in ranks:
                    self._groups[key] = (group, [int(r) for r in ranks])

    def _key(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank along `axes` (a name, or a tuple
        of names that is one axis or the data axes); the world's for all
        of them."""
        key = self._key(axes)
        if key == self.axis_names and dist.is_initialized() \
                and self.size == dist.get_world_size():
            return dist.group.WORLD
        if key not in self._groups:
            if not dist.is_initialized():
                raise RuntimeError('the mesh has no process group: start the ranks with '
                                   'parallel.spawn or torch.distributed.init_process_group')
            raise KeyError('the mesh has no group for axes {}'.format(key))
        return self._groups[key][0]

    def group_ranks(self, axes):
        """The global ranks of `group(axes)`, in mesh order."""
        key = self._key(axes)
        if key in self._groups:
            return list(self._groups[key][1])
        if key == self.axis_names:
            return [int(r) for r in self._ids.reshape(-1)]
        raise KeyError('the mesh has no group for axes {}'.format(key))

    def axis_size(self, axes):
        """The number of ranks along `axes` (1 for names the mesh lacks)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def axis_index(self, axes):
        """This rank's index along `axes`, outermost first (0 for names the
        mesh lacks): its shard of a batch sharded over them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        index = 0
        for a in axes:
            if a in self.shape:
                index = index * self.shape[a] + self.coords[a]
        return index

    def __repr__(self):
        return 'Mesh({}, rank={})'.format(dict(self.shape), self.rank)


def create_mesh(axes = None, *, devices = None, platform = None, rank = None):
    """A `Mesh` from an axis spec: a dict like ``{'dp': 4, 'tp': 2}`` (-1
    for one axis absorbs the remaining devices), or None for pure dp over
    every device.  `devices`: `RankDevice`s or global ranks (default: every
    rank of the job); `rank` picks the coordinates of a layout-only mesh."""
    devices = _as_devices(devices, platform)
    n = len(devices)
    axes = dict(axes) if axes is not None else {'dp': n}
    known = int(np.prod([v for v in axes.values() if v != -1]))
    for k, v in axes.items():
        if v == -1:
            axes[k] = n // known
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError('Mesh {} does not cover {} devices'.format(axes, n))
    grid = np.empty(n, dtype = object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(axes.values())), tuple(axes.keys()), rank = rank)


def create_hybrid_mesh(ici_axes, dcn_axes = None, *, devices = None, platform = None,
                       rank = None):
    """A mesh across slices: the `dcn_axes` (default ``{'dcn': 1}``) come
    first, outermost, the `ici_axes` within a slice: each slice is a
    contiguous block of ranks."""
    devices = _as_devices(devices, platform)
    dcn = dict(dcn_axes) if dcn_axes else {'dcn': 1}
    ici = dict(ici_axes)
    overlap = set(dcn) & set(ici)
    if overlap:
        raise ValueError('axes {} appear in both dcn and ici'.format(overlap))
    n_slices = int(np.prod(list(dcn.values())))
    per_slice = int(np.prod(list(ici.values())))
    if n_slices * per_slice != len(devices):
        raise ValueError('hybrid mesh dcn={} x ici={} does not cover {} devices'.format(
            dcn, ici, len(devices)))
    grid = np.empty(len(devices), dtype = object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(dcn.values()) + tuple(ici.values())),
                tuple(dcn.keys()) + tuple(ici.keys()), rank = rank)


def data_axes(mesh, candidates = ('dcn', 'dp')):
    """The mesh's data-parallel axes, outermost first: ('dcn', 'dp') on a
    hybrid mesh, ('dp',) on one slice."""
    return tuple(a for a in candidates if a in mesh.shape)


def data_size(mesh):
    """The number of batch shards: the product of the data axes."""
    return mesh.axis_size(data_axes(mesh))


# -- placements ------------------------------------------------------------------------

class Placement:
    """Where a leaf lives on the mesh: replicated (``axes`` empty), or its
    leading axis sharded over ``axes``; `place` applies one."""

    def __init__(self, mesh, axes = ()):
        self.mesh = mesh
        self.axes = tuple(a for a in axes if a in mesh.shape)

    def __repr__(self):
        return 'Placement({})'.format(self.axes or 'replicated')


def replicated(mesh):
    return Placement(mesh)


def batch_sharding(mesh, axis = 'dp'):
    """The leading axis over `axis` (a name or a tuple of names, e.g.
    ('dcn', 'dp')), the rest replicated."""
    return Placement(mesh, (axis,) if isinstance(axis, str) else tuple(axis))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def place(tree, placement):
    """Each leaf of `tree` (numpy arrays or tensors) as this rank holds it
    under `placement`: its rows of the shards when its leading dimension
    divides their number, else whole.  Tensors keep their device."""
    mesh, axes = placement.mesh, placement.axes
    n = mesh.axis_size(axes)
    index = mesh.axis_index(axes)

    def put(leaf):
        if n == 1 or np.ndim(leaf) == 0 or leaf.shape[0] % n:
            return leaf
        rows = leaf.shape[0] // n
        return leaf[index * rows: (index + 1) * rows]

    return _tree_map(put, tree)


def shard_batch(batch, mesh, axis = 'dp'):
    """This rank's rows of every leaf of `batch` whose leading dimension
    divides the number of shards over `axis` (a name or a tuple of names;
    names the mesh lacks are dropped); other leaves stay whole."""
    return place(batch, batch_sharding(mesh, axis))


def pad_batch_to_devices(batch, mesh, axis = 'dp', multiple = None):
    """Every array leaf's leading axis padded, by repeating its last row,
    to a multiple of the shards over `axis` (or of `multiple`, e.g. the
    data shards × the pipeline's microbatches)."""
    n = multiple if multiple is not None else mesh.axis_size(axis)

    def pad(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim == 0 or leaf.shape[0] % n == 0:
            return leaf
        reps = np.repeat(leaf[-1:], n - leaf.shape[0] % n, axis = 0)
        return np.concatenate([leaf, reps], axis = 0)

    return _tree_map(pad, batch)


# -- parameters ------------------------------------------------------------------------

def _flatten(tree, prefix = ()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(items):
    tree = {}
    for path, leaf in items:
        if not path:
            return leaf
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _slices(spec, shape, mesh, coords):
    index = []
    for dim, axis in enumerate(tuple(spec)):
        if axis is None or axis not in mesh.shape:
            index.append(slice(None))
            continue
        n = mesh.shape[axis]
        if shape[dim] % n:
            raise ValueError('dimension {} of size {} does not divide over {} = {}'.format(
                dim, shape[dim], axis, n))
        size = shape[dim] // n
        index.append(slice(coords[axis] * size, (coords[axis] + 1) * size))
    return tuple(index)


def shard_params(tree, mesh, specs = None):
    """A parameter tree of dicts of tensors on every rank of `mesh`, on its
    device: the tree of the mesh's first rank broadcast (the other ranks may
    pass None: they receive the structure too), or, given `specs`, each
    rank's slice of every sharded leaf, sent to it alone.  `specs` is a tree
    of `PartitionSpec` matching the tree, or a function of the tree that
    makes one (`moe_param_specs`), applied on the first rank.  Leaves of
    one dtype travel in one buffer.  Without a process group the slicing
    applies to the mesh's own ``rank``."""
    device = mesh.device
    leaves = _flatten(tree) if tree is not None else None
    if not dist.is_initialized():
        spec_tree = specs(tree) if callable(specs) else specs
        spec_of = dict(_flatten(spec_tree)) if spec_tree is not None else {}
        return _unflatten([(p, (v[_slices(spec_of[p], v.shape, mesh, mesh.coords)]
                                if spec_of.get(p) else v).to(device)) for p, v in leaves])
    group = mesh.group(mesh.axis_names)
    src = mesh.first_rank
    is_src = mesh.rank == src
    meta = None
    if is_src:
        spec_tree = specs(tree) if callable(specs) else specs
        spec_of = dict(_flatten(spec_tree)) if spec_tree is not None else {}
        meta = [(p, tuple(v.shape), v.dtype, tuple(spec_of.get(p, ()))) for p, v in leaves]
    meta = collectives.broadcast_object(meta, src, group)
    values = dict(leaves) if is_src else {}
    out = {}
    # replicated leaves: one broadcast for each dtype
    by_dtype = collections.OrderedDict()
    for i, (path, shape, dtype, spec) in enumerate(meta):
        if not any(a is not None for a in spec):
            by_dtype.setdefault(dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        sizes = [int(np.prod(meta[i][1])) for i in idx]
        if is_src:
            flat = torch.cat([values[meta[i][0]].detach().reshape(-1).to(device, dtype)
                              for i in idx])
        else:
            flat = torch.empty((sum(sizes),), dtype = dtype, device = device)
        collectives.broadcast_(flat, src, group)
        for i, part in zip(idx, torch.split(flat, sizes)):
            out[meta[i][0]] = part.view(meta[i][1]).clone()
    # sharded leaves: each rank's slice, sent to it alone
    ranks = [int(d.id) for d in mesh.devices.reshape(-1)]
    coords_of = {r: dict(zip(mesh.axis_names, (int(c) for c in np.argwhere(mesh._ids == r)[0])))
                 for r in ranks}
    for path, shape, dtype, spec in meta:
        if path in out:
            continue
        mine = _slices(spec, shape, mesh, mesh.coords)
        if is_src:
            full = values[path].detach()
            for r in ranks:
                part = full[_slices(spec, shape, mesh, coords_of[r])].contiguous()
                if r == src:
                    out[path] = part.to(device).clone()
                else:
                    collectives.send(part.to(device), r, group)
        else:
            part_shape = tuple(len(range(* s.indices(n))) for s, n in zip(mine, shape)) \
                + tuple(shape[len(mine):])
            out[path] = collectives.recv(part_shape, dtype, device, src, group)
    return _unflatten([(m[0], out[m[0]]) for m in meta])


def moe_param_specs(params, axis = 'ep'):
    """`PartitionSpec` tree of a mixture-of-experts `Transformer`: every
    stacked expert tensor (``experts/*/weight`` (E, out, in)) sharded on its
    expert axis over `axis`, every other leaf replicated.  Each rank then
    evaluates its experts and the combine all-reduces over `axis`."""
    def spec(tree, in_experts = False):
        if isinstance(tree, dict):
            return {k: spec(v, in_experts or k == 'experts') for k, v in tree.items()}
        return P(axis, None, None) if in_experts and tree.dim() == 3 else P()
    return spec(params)


def _path_specs(params, spec_for):
    """A `PartitionSpec` tree of `params`: ``spec_for('/'-joined path,
    leaf)`` for each tensor leaf."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        return spec_for('/'.join(prefix), tree)
    return walk(params, ())


def waveglow_param_specs(params, axis = 'tp'):
    """`PartitionSpec` tree of WaveGlow (the port's layouts, conv weights
    (out, in, W)): each WN block's hidden channels over `axis`, as the JAX
    package's spec: ``start`` on its out channels, ``in_conv``,
    ``res_skip_conv`` and ``end`` on their in channels; the conditioning
    convs, the biases, the 1×1 inverses and the upsample replicated.  The
    block's collectives (`models.waveglow_arch`) run inside
    `collectives.tensor_shard`."""
    def spec_for(name, leaf):
        if 'block' in name and leaf.dim() == 3:
            if 'start' in name:
                return P(axis, None, None)            # out = hidden
            if 'in_conv' in name:
                return P(None, axis, None)            # in = hidden (out = 2 hidden whole)
            if 'cond_conv' in name:
                return P()
            if 'res_skip_conv' in name or 'end' in name:
                return P(None, axis, None)
        return P()
    return _path_specs(params, spec_for)


def _fft_block_spec(name, leaf, axis):
    """Megatron's split of a post-LN FFT block (dense weights (out, in),
    conv weights (out, in, W)): q / k / v and ``conv1`` on their out
    dimension with their biases, ``output`` and ``conv2`` on their in
    dimension; None for any other leaf."""
    if leaf.dim() == 2:
        if any(k in name for k in ('query/', 'key/', 'value/')):
            return P(axis, None)
        if 'output/' in name:
            return P(None, axis)
    if leaf.dim() == 3:
        if 'conv1' in name:
            return P(axis, None, None)
        if 'conv2' in name:
            return P(None, axis, None)
    if leaf.dim() == 1 and any(k in name for k in ('query/', 'key/', 'value/', 'conv1')):
        return P(axis)
    return None


def fastspeech2_param_specs(params, axis = 'tp'):
    """`PartitionSpec` tree of FastSpeech-2: Megatron tensor parallelism of
    the encoder's and decoder's FFT blocks (each rank ``n_heads / tp``
    heads and ``ffn_dim / tp`` FFN channels, one all-reduce a sub-layer),
    the variance predictors, embeddings, norms and postnet replicated."""
    def spec_for(name, leaf):
        return (_fft_block_spec(name, leaf, axis) if 'layer_' in name else None) or P()
    return _path_specs(params, spec_for)


def vits_param_specs(params, axis = 'tp'):
    """`PartitionSpec` tree of VITS: Megatron's split of the text encoder's
    blocks (the relative tables, shared by the heads, replicated),
    channel-TP of the posterior's and the flows' WaveNet stacks
    (``in_conv`` and ``res_skip_conv`` on their in channels), and the
    HiFi-GAN generator's ``conv_pre`` on its out channels and first
    upsample (a transposed conv, weight (in, out, W)) on its in channels;
    the rest replicated."""
    def spec_for(name, leaf):
        if 'text_encoder/' in name:
            spec = _fft_block_spec(name, leaf, axis)
            if spec is not None:
                return spec
        if '/wn/' in name and leaf.dim() == 3 and ('in_conv' in name
                                                  or 'res_skip_conv' in name):
            return P(None, axis, None)
        if 'generator/' in name and leaf.dim() == 3:
            if 'conv_pre' in name or 'up0/up' in name:
                return P(axis, None, None)
        return P()
    return _path_specs(params, spec_for)


def tacotron2_param_specs(params, axis = 'tp'):
    """`PartitionSpec` tree of Tacotron-2: the attention and decoder LSTMs'
    gate rows (``weight_ih`` / ``weight_hh`` (4H, ·)) and the frame
    projection's out rows over `axis`, the rest replicated.

    As in the JAX package, this is the teacher-forced training pass's
    split (the 4H pre-activations and the frame gathered every step), not
    a serving plan: an autoregressive decode would gather every step, so
    `infer` and `infer_fused` under `tp` raise.  The multi-card serving
    story is the batch over ``dp`` and channel-TP of the vocoder
    (`waveglow_param_specs`)."""
    def spec_for(name, leaf):
        if leaf.dim() == 2 and any(k in name for k in (
                'attention_rnn/weight_ih', 'attention_rnn/weight_hh', 'decoder_rnn',
                'linear_projection/weight')):
            return P(axis, None)
        return P()
    return _path_specs(params, spec_for)


def gather_params(tree, mesh, specs):
    """The whole tree on every rank from each rank's `shard_params` slices:
    every sharded leaf gathered along its sharded dimensions (`specs` a
    tree or a function of the tree, as `shard_params` takes)."""
    spec_tree = specs(tree) if callable(specs) else specs
    spec_of = dict(_flatten(spec_tree))
    out = []
    for path, leaf in _flatten(tree):
        for dim, axis in enumerate(tuple(spec_of.get(path, ()))):
            if axis is not None and mesh.shape.get(axis, 1) > 1:
                leaf = torch.cat(collectives.all_gather(leaf.contiguous(), mesh.group(axis)),
                                 dim = dim)
        out.append((path, leaf))
    return _unflatten(out)


def shard_sequence(x, mesh, axis = 'sp', dim = 1):
    """This rank's part of `x` (numpy or a tensor) along `dim` (time),
    equal parts over `axis` in axis order; `x` whole without the axis."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError('{} steps do not divide over {} = {}'.format(x.shape[dim], axis, n))
    size = x.shape[dim] // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(mesh.coords[axis] * size, (mesh.coords[axis] + 1) * size)
    return x[tuple(index)]


# -- local processes -------------------------------------------------------------------

def init_process(rank, world_size, *, backend, device, init_method, timeout = 600.):
    """Join a job as `rank`: one torch thread, the rank's `device` (a CUDA
    device is made current) and the process group on `backend`."""
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    _PROCESS['device'] = device
    dist.init_process_group(backend, init_method = init_method, world_size = world_size,
                            rank = rank, timeout = datetime.timedelta(seconds = timeout))
    return device


def _child(index, payload, world_size, backend, device, tmp, timeout):
    init_process(index, world_size, backend = backend, device = device,
                 init_method = 'file://' + os.path.join(tmp, 'store'), timeout = timeout)
    try:
        fn, args = pickle.loads(payload)
        out = fn(* args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, 'result-{}.pkl'.format(index)), 'wb') as f:
        pickle.dump(out, f)


def check_backend(backend, world_size):
    """Refuse what the backend cannot run: NCCL takes one rank a card."""
    if backend not in ('gloo', 'nccl'):
        raise ValueError('backend must be "gloo" or "nccl", not {!r}'.format(backend))
    if backend == 'nccl':
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > cards:
            raise ValueError('NCCL takes one rank a card: {} ranks, {} cards (gloo runs '
                             'several ranks on one device)'.format(world_size, cards))


def spawn(fn, world_size, *, backend, device, args = (), timeout = 600.):
    """Run ``fn(* args)`` in `world_size` new processes, rank i the i-th,
    each joined to one process group on `backend` ('gloo' or 'nccl'; NCCL
    needs a card for each rank) with `device` ('cpu', or 'cuda': rank i
    takes card i modulo the cards).  Each child runs one torch thread (and
    one BLAS thread).  Returns every rank's return value, in rank order; the
    error of any child is raised here (the others are stopped).  `fn`, its
    arguments and its result must pickle, and `fn`'s module must import in a
    fresh interpreter."""
    check_backend(backend, world_size)
    tmp = tempfile.mkdtemp(prefix = 'tts-mesh-')
    threads = ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS')
    saved = {k: os.environ.get(k) for k in threads}
    os.environ.update({k: '1' for k in threads})
    try:
        # plain pickle: each child gets its own copy of the arguments (the
        # multiprocessing pickler would share CPU tensors' storage, which a
        # child updating its parameters in place would write through)
        payload = pickle.dumps((fn, tuple(args)))
        ctx = torch.multiprocessing.start_processes(
            _child, args = (payload, world_size, backend, str(device), tmp, timeout),
            nprocs = world_size, join = False, start_method = 'spawn')
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        while not ctx.join():
            pass
        out = []
        for i in range(world_size):
            with open(os.path.join(tmp, 'result-{}.pkl'.format(i)), 'rb') as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(tmp, ignore_errors = True)


__all__ = ['Mesh', 'P', 'PartitionSpec', 'Placement', 'RankDevice', 'batch_sharding',
           'check_backend', 'create_hybrid_mesh', 'create_mesh', 'data_axes', 'data_size',
           'fastspeech2_param_specs', 'gather_params', 'get_devices', 'init_process',
           'moe_param_specs', 'pad_batch_to_devices', 'place', 'replicated', 'shard_batch',
           'shard_params', 'shard_sequence', 'spawn', 'tacotron2_param_specs',
           'vits_param_specs', 'waveglow_param_specs']
