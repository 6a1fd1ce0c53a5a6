"""The dp x feat mesh of the SOMF step, through ``torch.distributed``.

Counterpart of ``modl_tpu/parallel/mesh.py``. The estimators stay SPMD:
one process per card (``torchrun``, or :func:`..launch.spawn`), every
rank calling ``fit`` with the same data and the same ``random_state``,
so that the host draws (windows, subsets, atom orders, permutations)
are the same on every rank. Each rank holds only its shards:

- ``dp``: minibatch rows and the per-sample statistics (``code``,
  ``Dx_avg``, ``G_avg``, ``sample_n_iter``) are split over the ranks;
  each rank solves the codes of its own rows;
- ``feat``: the feature axis of D, B and X is split (fMRI dictionaries
  are ~2e5 voxels wide).

A shard is a contiguous block, in rank order, of an axis its mesh axis
divides; an axis that does not divide evenly stays replicated (the JAX
package's ``_spec_for_leaf``, ``_dp_ok`` and ``_feat_ok``). The feature
axis splits only when ``feat > 1``.

Every collective is a SUM ``all_reduce`` on the ``dp`` or the ``feat``
sub-group, the gathers included: a rank writes its part into a zero
buffer and the sum reassembles the whole, as the JAX package's
``shard_map`` + ``psum`` gathers do. Adding zeros is exact, so a
reassembly changes no bit. ``COLLECTIVES`` counts the calls and their
bytes, as ``ops/bcd.py``'s ``LAUNCHES`` counts kernel launches. Gloo
takes CUDA tensors for ``all_reduce``, so a gloo world of ranks sharing
one card runs the same program as an NCCL world.
"""
import collections
import dataclasses
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "config_for_mesh", "shard_state", "shard_batch",
           "shard_batches", "shard_indices", "unshard",
           "unshard_leaf", "unshard_state", "all_reduce_sum", "gather_rows",
           "scatter_rows", "put_owned", "assemble_cols", "check_same",
           "Layout", "COLLECTIVES"]

AXES = ('dp', 'feat')

# SUM all-reduces made by all_reduce_sum: 'calls' and 'bytes' in all,
# and 'calls_dp', 'calls_feat', 'bytes_dp', 'bytes_feat' by axis (read
# by chip_smoke.py; reset with COLLECTIVES.clear())
COLLECTIVES = collections.Counter()

def make_mesh(n_dp=None, n_feat=1, device_type='cuda'):
    """A ``('dp', 'feat')`` :class:`DeviceMesh` over the initialised
    default group: rank ``r`` sits at ``(r // n_feat, r % n_feat)``.

    ``device_type`` is where the ranks keep their tensors: ``'cuda'``
    unless the caller asks for ``'cpu'``. Raises where no group is
    initialised or ``n_dp * n_feat`` is not the world size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs an initialised process group '
                           '(torch.distributed.init_process_group)')
    world = dist.get_world_size()
    if n_dp is None:
        n_dp = world // n_feat
    if n_dp * n_feat != world:
        raise ValueError('n_dp * n_feat (%d*%d) != world size (%d)'
                         % (n_dp, n_feat, world))
    return DeviceMesh(device_type, torch.arange(world).reshape(n_dp, n_feat),
                      mesh_dim_names=AXES)


def size(mesh, axis):
    """Ranks along ``axis`` (1 off-mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[AXES.index(axis)]


def coord(mesh, axis):
    """This rank's position along ``axis`` (0 off-mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def rows_split(mesh, n):
    """Whether an axis of ``n`` rows is split over ``dp`` (a one-rank
    ``dp`` splits too, so its collectives still run)."""
    return mesh is not None and n % size(mesh, 'dp') == 0


def cols_split(mesh, n):
    """Whether a feature axis of width ``n`` is split over ``feat``."""
    return (mesh is not None and size(mesh, 'feat') > 1
            and n % size(mesh, 'feat') == 0)


def block(mesh, axis, n, split):
    """``(offset, length)`` of this rank's block of an axis of ``n``."""
    if not split:
        return 0, n
    m = n // size(mesh, axis)
    return coord(mesh, axis) * m, m


@dataclasses.dataclass(frozen=True)
class Layout:
    """Global sizes of a sharded :class:`SomfState`: ``n_stored`` columns
    of D and B (``n_pad`` trailing zero columns among them, which make a
    windowed width a ``feat`` multiple) and ``n_samples`` rows of the
    per-sample statistics."""
    mesh: DeviceMesh
    n_stored: int
    n_samples: int
    n_pad: int = 0

    @property
    def split_cols(self):
        return cols_split(self.mesh, self.n_stored)

    @property
    def split_rows(self):
        return rows_split(self.mesh, self.n_samples)

    def cols(self):
        """``(offset, width)`` of this rank's columns of D and B."""
        return block(self.mesh, 'feat', self.n_stored, self.split_cols)

    def rows(self):
        """``(offset, count)`` of this rank's per-sample rows."""
        return block(self.mesh, 'dp', self.n_samples, self.split_rows)


def config_for_mesh(cfg, mesh):
    """``cfg`` with its mesh recorded (``SomfConfig.mesh``): the step
    then runs on a state sharded by :func:`shard_state`."""
    return dataclasses.replace(cfg, mesh=mesh)


def all_reduce_sum(t, mesh, axis):
    """SUM all-reduce of the contiguous tensor ``t`` over ``axis``'s
    sub-group, in place; returns ``t``. Counted in ``COLLECTIVES``."""
    if not t.is_contiguous():
        raise ValueError('all_reduce_sum takes a contiguous tensor')
    group = mesh.get_group(axis)
    nbytes = t.numel() * t.element_size()
    COLLECTIVES.update({'calls': 1, 'bytes': nbytes, f'calls_{axis}': 1,
                        f'bytes_{axis}': nbytes})
    dist.all_reduce(t, group=group)
    return t


def _take(t, dim, offset, length):
    return t.narrow(dim, offset, length).contiguous()


def shard_batch(X, mesh, feat=False):
    """This rank's block of a (b, n) minibatch: rows over ``dp`` where
    ``dp`` divides b, columns over ``feat`` (with ``feat``) where it
    divides n; otherwise the axis stays whole."""
    return shard_batches(X[None], mesh, feat)[0]


def shard_batches(Xb, mesh, feat=False):
    """This rank's block of stacked (T, b, n) minibatches."""
    b, n = Xb.shape[1], Xb.shape[2]
    Xb = _take(Xb, 1, *block(mesh, 'dp', b, rows_split(mesh, b)))
    if feat:
        Xb = _take(Xb, 2, *block(mesh, 'feat', n, cols_split(mesh, n)))
    return Xb


def shard_indices(idx, mesh):
    """This rank's ``dp`` block of a (b,) or (T, b) batch-row array (the
    rows this rank solves); the whole array where ``dp`` does not
    divide b."""
    b = idx.shape[-1]
    return _take(idx, idx.ndim - 1, *block(mesh, 'dp', b,
                                           rows_split(mesh, b)))


# per-sample statistics, split over dp; D and B, split over feat
SAMPLE_LEAVES = ('code', 'Dx_avg', 'G_avg', 'sample_n_iter')
FEATURE_LEAVES = ('D', 'B')


def shard_state(state, mesh, n_pad=0):
    """This rank's shards of a global :class:`SomfState`: D and B over
    ``feat`` (after ``n_pad`` zero columns are appended), the per-sample
    statistics over ``dp``, the rest replicated; the state records its
    :class:`Layout`."""
    padded = {name: torch.nn.functional.pad(getattr(state, name),
                                            (0, n_pad))
              for name in FEATURE_LEAVES}
    layout = Layout(mesh, padded['D'].shape[1],
                    state.sample_n_iter.shape[0], n_pad)
    c0, nc = layout.cols()
    r0, nr = layout.rows()
    out = {name: _take(padded[name], 1, c0, nc) for name in FEATURE_LEAVES}
    for name in SAMPLE_LEAVES:
        leaf = getattr(state, name)
        out[name] = None if leaf is None else _take(leaf, 0, r0, nr)
    return dataclasses.replace(state, layout=layout, **out)


def unshard(t, mesh, axis, dim, n, split):
    """The global tensor of which ``t`` is this rank's block along
    ``dim`` (``n`` long, split over ``axis`` when ``split``), on every
    rank: the block written into zeros, then one SUM all-reduce."""
    if not split:
        return t
    offset, length = block(mesh, axis, n, split)
    shape = list(t.shape)
    shape[dim] = n
    out = t.new_zeros(shape)
    out.narrow(dim, offset, length).copy_(t)
    return all_reduce_sum(out, mesh, axis)


def unshard_leaf(state, name):
    """State leaf ``name`` whole on every rank (D and B without the zero
    pad columns): a collective for a split leaf of a sharded state, the
    leaf itself otherwise."""
    leaf = getattr(state, name)
    lay = state.layout
    if lay is None or leaf is None:
        return leaf
    if name in FEATURE_LEAVES:
        full = unshard(leaf, lay.mesh, 'feat', 1, lay.n_stored,
                       lay.split_cols)
        return full[:, :lay.n_stored - lay.n_pad].contiguous()
    if name in SAMPLE_LEAVES:
        return unshard(leaf, lay.mesh, 'dp', 0, lay.n_samples,
                       lay.split_rows)
    return leaf


def unshard_state(state):
    """The whole state of a sharded one, on every rank, without the
    zero pad columns and without a layout (a collective: every rank
    calls it)."""
    if state.layout is None:
        return state
    return dataclasses.replace(
        state, layout=None, **{name: unshard_leaf(state, name)
                               for name in FEATURE_LEAVES + SAMPLE_LEAVES})


def gather_rows(leaves, idx, mesh, n, split):
    """Rows ``idx`` (global, (b,)) of per-sample leaves split over
    ``dp`` (``n`` rows in all), on every rank: each rank fills the rows
    it owns into zeros and one SUM all-reduce per dtype reassembles
    them. Returns the (b, ...) blocks in the order of ``leaves``."""
    if not split:
        return [leaf[idx] for leaf in leaves]
    local, own = owned(idx, mesh, n)
    parts = []
    for leaf in leaves:
        rows = leaf[local]
        mask = own.reshape((-1,) + (1,) * (rows.ndim - 1))
        parts.append(torch.where(mask, rows, torch.zeros_like(rows)))
    out = [None] * len(parts)
    by_dtype = collections.defaultdict(list)
    for i, part in enumerate(parts):
        by_dtype[part.dtype].append(i)
    b = idx.shape[0]
    for ids in by_dtype.values():
        flat = torch.cat([parts[i].reshape(b, -1) for i in ids], dim=1)
        all_reduce_sum(flat, mesh, 'dp')
        for i, piece in zip(ids, flat.split(
                [parts[i][0].numel() for i in ids], dim=1)):
            out[i] = piece.reshape(parts[i].shape)
    return out


def owned(idx, mesh, n):
    """``(local, own)`` for global rows ``idx`` of a ``dp``-split leaf of
    ``n`` rows: the local row (0 where not owned) and whether this rank
    owns it."""
    offset, length = block(mesh, 'dp', n, True)
    local = idx - offset
    own = (local >= 0) & (local < length)
    return torch.where(own, local, torch.zeros_like(local)), own


def scatter_rows(leaf, idx, values, mesh, n, split):
    """Write the (b, ...) ``values`` of rows ``idx`` (global) into a
    per-sample leaf: each rank writes the rows it owns, no collective."""
    if not split:
        leaf[idx] = values
        return
    put_owned(leaf, 0, *owned(idx, mesh, n), values)


def put_owned(dst, dim, local, own, values):
    """``dst.index_copy_(dim, local[own], values[own])`` without reading
    the mask back to the host: the entries this rank does not own write
    the first owned entry's value to its index once more (identical
    writes, so their order is moot), or, where it owns none, index 0's
    own value back."""
    first = torch.argmax(own.to(torch.int8))
    some = own[first]
    index = torch.where(own, local,
                        torch.where(some, local[first],
                                    torch.zeros_like(local[first])))
    fill = torch.where(some, values.select(dim, first), dst.select(dim, 0))
    shape = [1] * values.ndim
    shape[dim] = -1
    dst.index_copy_(dim, index, torch.where(own.reshape(shape), values,
                                            fill.unsqueeze(dim)))


def assemble_cols(A, cols, width, mesh):
    """The (rows, ``width``) block of columns of a feature-split array:
    ``cols`` holds, for every output column, the local column of ``A``
    that this rank owns (or -1); each rank fills those into zeros and a
    SUM all-reduce over ``feat`` reassembles the block."""
    own = cols >= 0
    out = A[:, torch.where(own, cols, torch.zeros_like(cols))]
    out = torch.where(own[None, :], out, torch.zeros_like(out))
    return all_reduce_sum(out.contiguous(), mesh, 'feat')


def check_same(values, mesh, what):
    """Raise on every rank unless every rank of the mesh passed the same
    int64 ``values``: each axis' ranks are gathered by the zero-pad
    all-reduce and compared."""
    v = torch.as_tensor(np.asarray(values, np.int64))
    device = 'cuda' if mesh.device_type == 'cuda' else 'cpu'
    for axis in AXES:
        m = size(mesh, axis)
        buf = torch.zeros((m, v.numel()), dtype=torch.int64, device=device)
        buf[coord(mesh, axis)] = v.to(device)
        all_reduce_sum(buf, mesh, axis)
        if not bool((buf == buf[:1]).all()):
            raise RuntimeError(
                f'the ranks of the mesh disagree on {what} along {axis!r}: '
                'every rank must pass the same data and random_state')


def fingerprint(*arrays):
    """A 31-bit crc32 of host arrays (numpy or CPU tensors)."""
    h = 0
    for a in arrays:
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        h = zlib.crc32(np.ascontiguousarray(a).tobytes(), h)
    return h
