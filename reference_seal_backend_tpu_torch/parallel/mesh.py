"""Device meshes, and the sharded tensor of the port's parallel path.

Counterpart of ``reference_seal_backend_tpu/parallel/mesh.py``.  The JAX
package places arrays on a ``jax.sharding.Mesh`` and GSPMD partitions the
evaluator's functions over it.  The port runs one process whose mesh is an
array of ``torch.device`` (``utils/device.py:mesh_devices``: one per card, or
virtual shards of one card) and holds a sharded array as a
:class:`ShardedTensor`: one block per mesh device, and a spec naming, for
each dim, the mesh axis it is split over (None: whole in every block).

A ``ShardedTensor`` runs torch's operations as a local map, the way
``shard_map`` runs one body per shard: pointwise and broadcasting
arithmetic, and indexing, ``cat``, ``stack``, ``reshape``, ``expand``,
``squeeze`` and ``index_select`` that leave every sharded dim whole in
place, run block by block, a plain tensor operand taking each block's part
on the block's device.  An operation that would read across a sharded dim,
or has no local form (a whole transform, a kernel), raises
``NotImplementedError`` naming it: there is no implicit gather.  Whole
functions of a dp-sharded batch run per block through :func:`shard_map`;
the evaluator's key switch, rotations, rescale, mod switch and BFV
multiply of limb-sharded data run through ``parallel/limb.py``.  Data
moves between blocks only through the explicit collectives here
(:meth:`ShardedTensor.gather`, :func:`gather_index`, :func:`roll_segments`
for the sp layout; :func:`all_gather_dim`, :func:`all_reduce_mod`,
:func:`rebalance` for the limb path) and the sharded NTT's all-to-all
(``parallel/sharded_ntt.py``),
each counted in :data:`counts` while ``parallel/sp_eval.py:collective_stats``
runs.

Axis -> fabric contract of the reference: ``dp`` (the ciphertext batch) is
the only axis that may span hosts; ``sp`` and ``limb`` stay within one.
:func:`make_process_mesh` orders devices process-major and checks that
(:func:`process_grouped_order`, copied from the reference: it is plain
numpy).  The port runs in one process, so every process index is 0 unless a
caller passes others.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.utils.device import mesh_devices

COLLECTIVES = ("all-to-all", "all-gather", "collective-permute", "all-reduce")

#: While not None, every collective of the port's parallel path adds one to
#: its kind here, and the all-to-alls their bytes to ``a2a_bytes``
#: (``sp_eval.collective_stats`` sets it around one call).  A collective
#: over a mesh axis of one device moves nothing and is not counted.
counts: Optional[Dict[str, int]] = None


def zero_counts() -> Dict[str, int]:
    """A fresh :data:`counts`: every kind of ``COLLECTIVES`` and
    ``a2a_bytes`` at 0."""
    return {**dict.fromkeys(COLLECTIVES, 0), "a2a_bytes": 0}


def count(kind: str, nbytes: int = 0) -> None:
    if counts is not None:
        counts[kind] += 1
        if kind == "all-to-all":
            counts["a2a_bytes"] += nbytes


class Mesh:
    """An n-d array of ``torch.device`` with named axes; ``shape`` is a
    dict, as ``jax.sharding.Mesh``'s."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {devices.shape} with axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def unique_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _device_array(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("dp", "limb"),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Mesh over the first ``n_devices`` of ``devices`` (default: the cards,
    ``mesh_devices``).  The default shape puts every device on ``dp`` but a
    factor of 2 on ``limb`` when the count is even."""
    if devices is None:
        devices = mesh_devices(None, n_devices or max(torch.cuda.device_count(), 1))
    devs = list(devices)
    n = n_devices or len(devs)
    devs = devs[:n]
    if shape is None:
        if len(axes) == 2:
            limb = 2 if n % 2 == 0 and n > 1 else 1
            shape = (n // limb, limb)
        else:
            shape = (n,) + (1,) * (len(axes) - 1)
    return Mesh(_device_array(devs, shape), axes)


def process_grouped_order(
    process_indices: Sequence[int], group: int
) -> np.ndarray:
    """Device ordering for a process-aware (dp, sp) mesh.

    Given each device's ``process_index`` and the sp axis size ``group``,
    return the permutation that orders devices process-major, and check
    that every contiguous ``group``-sized block then lies inside ONE
    process — the invariant that keeps sp collectives (all_to_all per
    NTT, all-gather per key switch) on ICI while only the dp axis
    crosses hosts over DCN.  Raises if the topology cannot satisfy it
    (group larger than a host, or not dividing the per-host count).
    """
    procs = np.asarray(process_indices)
    n = procs.size
    if n % group:
        raise ValueError(f"{n} devices do not divide into sp groups of {group}")
    order = np.argsort(procs, kind="stable")
    grouped = procs[order].reshape(n // group, group)
    if not (grouped == grouped[:, :1]).all():
        counts = np.bincount(procs)
        raise ValueError(
            "sp axis would cross a host boundary (DCN): sp group size "
            f"{group} does not pack into per-process device counts "
            f"{counts.tolist()} — shrink sp or use a host-local mesh"
        )
    return order


def make_process_mesh(
    sp: int,
    axes: Tuple[str, str] = ("dp", "sp"),
    devices: Optional[Sequence[torch.device]] = None,
    process_indices: Optional[Sequence[int]] = None,
) -> Mesh:
    """Process-aware (dp, sp) mesh: ``sp`` is the sp axis size, every other
    factor of the device count goes to dp, devices ordered process-major so
    that each sp group stays within one process.  ``process_indices``
    (default all 0: the port is one process) gives each device's process."""
    devs = list(devices) if devices is not None else mesh_devices(None, sp)
    procs = [0] * len(devs) if process_indices is None else process_indices
    order = process_grouped_order(procs, sp)
    return Mesh(
        _device_array([devs[i] for i in order], (len(devs) // sp, sp)), axes)


def ct_pspec(
    n_batch_axes: int,
    batch_axes: Sequence[Optional[str]] = ("dp",),
    limb_axis: Optional[str] = None,
) -> Tuple[Optional[str], ...]:
    """Spec of ciphertext data ``[batch…, size, limb, N]``."""
    batch = list(batch_axes)[:n_batch_axes]
    batch += [None] * (n_batch_axes - len(batch))
    return (*batch, None, limb_axis, None)


def pt_pspec(
    n_batch_axes: int,
    batch_axes: Sequence[Optional[str]] = ("dp",),
    limb_axis: Optional[str] = None,
) -> Tuple[Optional[str], ...]:
    """Spec of plaintext data ``[batch…, limb, N]``."""
    batch = list(batch_axes)[:n_batch_axes]
    batch += [None] * (n_batch_axes - len(batch))
    return (*batch, limb_axis, None)


def shard_ct(
    ct,
    mesh: Mesh,
    n_batch_axes: int = 0,
    batch_axes: Sequence[Optional[str]] = ("dp",),
    limb_axis: Optional[str] = None,
):
    """Place a Ciphertext's / Plaintext's data onto the mesh."""
    is_pt = ct.data.ndim == n_batch_axes + 2  # plaintext: [batch…, L, N]
    spec = (pt_pspec if is_pt else ct_pspec)(n_batch_axes, batch_axes, limb_axis)
    return dataclasses.replace(ct, data=ShardedTensor.distribute(ct.data, mesh, spec))


def shard_map(fn, *cts):
    """``fn`` once per block, on each block's part of the placed
    ciphertexts / plaintexts ``cts`` (:func:`shard_ct`), as ``shard_map``
    runs one body per shard; the result is placed as ``cts[0]`` is.  Each
    block must be a batch of whole polynomials (a dp-sharded batch): with
    the limb or the coefficient axis sharded, ``fn``'s per-limb constants
    and transforms would see only a block's part, so that raises."""
    x = cts[0].data
    for ct in cts:
        if ct.data.mesh is not x.mesh or ct.data.spec != x.spec:
            raise NotImplementedError("shard_map over differently placed operands")
    if any(a is not None for a in x.spec[-2:]):
        raise NotImplementedError(
            f"shard_map over data placed as {x.spec}: a block holding part of "
            f"a sharded dim (limb or coefficient axis) is not a batch of "
            f"whole polynomials")
    outs = {c: fn(*(dataclasses.replace(ct, data=ct.data.blocks[c]) for ct in cts))
            for c in _coords(x.mesh)}
    blocks = np.empty(x.mesh.devices.shape, dtype=object)
    for c, out in outs.items():
        blocks[c] = out.data
    return dataclasses.replace(next(iter(outs.values())),
                               data=ShardedTensor(blocks, x.mesh, x.spec))


def replicate(tree, mesh: Mesh):
    """Keys and other operands that every shard reads.  A plain tensor is a
    replicated operand of the ``ShardedTensor`` local map already (each
    block's op takes it on the block's device), so this places every tensor
    of ``tree`` (dataclasses, dicts, lists and tuples of them) on the mesh's
    first device."""
    return to_device(tree, mesh.devices.flat[0])


def to_device(tree, dev: torch.device):
    """Every tensor of ``tree`` (dataclasses, dicts, lists and tuples of
    them) on ``dev``; anything else as it is."""

    def place(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: place(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(tree)


# ---------------------------------------------------------------------------
# The sharded tensor.
# ---------------------------------------------------------------------------

def _coords(mesh: Mesh):
    return list(np.ndindex(mesh.devices.shape))


def _axis_index(mesh: Mesh, axis: Optional[str], c) -> int:
    return c[mesh.axis_names.index(axis)] if axis is not None else 0


def _along(mesh: Mesh, axis: str, c, i: int):
    """Coordinate ``c`` with its ``axis`` entry replaced by ``i``."""
    pos = mesh.axis_names.index(axis)
    return c[:pos] + (i,) + c[pos + 1 :]


def _local_part(t: torch.Tensor, spec, shape, mesh: Mesh, c) -> torch.Tensor:
    """Block ``c``'s part of a plain tensor that broadcasts against a
    sharded operand of ``shape`` / ``spec`` (right-aligned), on the block's
    device: a sharded dim it spans in full is cut to the block's slice."""
    off = len(spec) - t.dim()
    for d, a in enumerate(spec):
        e = d - off
        if a is None or e < 0 or t.shape[e] == 1:
            continue
        if t.shape[e] != shape[d]:
            raise ValueError(
                f"operand of shape {tuple(t.shape)} does not broadcast "
                f"against the sharded shape {tuple(shape)}")
        step = shape[d] // mesh.shape[a]
        t = t.narrow(e, _axis_index(mesh, a, c) * step, step)
    return t.to(mesh.devices[c])


def _substitute(obj, c, mesh, spec, shape):
    if isinstance(obj, ShardedTensor):
        return obj.blocks[c]
    if isinstance(obj, torch.Tensor):
        return _local_part(obj, spec, shape, mesh, c)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_substitute(o, c, mesh, spec, shape) for o in obj)
    if isinstance(obj, dict):
        return {k: _substitute(v, c, mesh, spec, shape) for k, v in obj.items()}
    return obj


def _find(obj, out: list) -> list:
    if isinstance(obj, (ShardedTensor, torch.Tensor)):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _find(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _find(o, out)
    return out


def _mesh_of(operands) -> Mesh:
    meshes = {id(o.mesh): o.mesh for o in operands if isinstance(o, ShardedTensor)}
    if len(meshes) != 1:
        raise NotImplementedError("operands sharded over different meshes")
    return next(iter(meshes.values()))


def _blockwise(func, args, kwargs, spec, shape, out_spec) -> "ShardedTensor":
    """``func`` once per block: sharded operands give their block, plain
    tensors their part (aligned against ``shape`` / ``spec``)."""
    mesh = _mesh_of(_find((args, kwargs), []))
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for c in _coords(mesh):
        a = _substitute(args, c, mesh, spec, shape)
        k = _substitute(kwargs, c, mesh, spec, shape)
        blocks[c] = func(*a, **k)
    return ShardedTensor(blocks, mesh, out_spec)


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} on a ShardedTensor reads across a sharded dim; data moves "
        f"between blocks only through the collectives of parallel/mesh.py")


def _elementwise(func, args, kwargs):
    operands = _find((args, kwargs), [])
    shape = torch.broadcast_shapes(*(o.shape for o in operands))
    nd = len(shape)
    spec: List[Optional[str]] = [None] * nd
    sharded = [o for o in operands if isinstance(o, ShardedTensor)]
    for o in sharded:
        off = nd - o.ndim
        for d, a in enumerate(o.spec):
            if a is not None:
                if spec[d + off] not in (None, a):
                    _refuse(f"{func.__name__} of differently sharded operands")
                spec[d + off] = a
    for o in sharded:  # a whole dim against a sharded one: layouts differ
        off = nd - o.ndim
        for d, a in enumerate(spec):
            if a and d >= off and o.spec[d - off] is None and o.shape[d - off] != 1:
                _refuse(f"{func.__name__} of differently sharded operands")
    return _blockwise(func, args, kwargs, spec, shape, tuple(spec))


def _dim(d: int, nd: int) -> int:
    if not -nd <= d < nd:
        raise IndexError(f"dim {d} of a {nd}-d ShardedTensor")
    return d % nd


def _cat(tensors, dim=0, **kw):
    sharded = [t for t in tensors if isinstance(t, ShardedTensor)]
    spec = sharded[0].spec
    if any(t.spec != spec for t in sharded):
        _refuse("cat of differently sharded operands")
    d = _dim(dim, len(spec))
    if spec[d]:
        _refuse("cat along a sharded dim")
    return _blockwise(torch.cat, (list(tensors),), {"dim": d}, spec,
                      sharded[0].shape, spec)


def _stack(tensors, dim=0, **kw):
    sharded = [t for t in tensors if isinstance(t, ShardedTensor)]
    spec = sharded[0].spec
    if any(t.spec != spec for t in sharded):
        _refuse("stack of differently sharded operands")
    d = _dim(dim, len(spec) + 1)
    return _blockwise(torch.stack, (list(tensors),), {"dim": d}, spec,
                      sharded[0].shape, spec[:d] + (None,) + spec[d:])


def _sizes(args) -> List[int]:
    if len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)):
        return list(args[0])
    return list(args)


class ShardedTensor:
    """A global tensor held as one block per device of ``mesh``.

    ``spec[d]`` names the mesh axis dim ``d`` is split over (equal
    consecutive parts, in axis order), or is None where every block holds
    the dim whole; mesh axes that no dim names replicate.  ``shape``,
    ``ndim`` and ``dtype`` are the global tensor's."""

    def __init__(self, blocks: np.ndarray, mesh: Mesh, spec: Sequence[Optional[str]]):
        self.blocks = blocks
        self.mesh = mesh
        self.spec = tuple(spec)
        b = blocks.flat[0]
        if b.dim() != len(self.spec):
            raise ValueError(f"spec {self.spec} for a {b.dim()}-d block")
        self.shape = torch.Size(
            n * (mesh.shape[a] if a else 1) for n, a in zip(b.shape, self.spec))

    @classmethod
    def distribute(cls, x: torch.Tensor, mesh: Mesh, spec) -> "ShardedTensor":
        """Cut ``x`` into the blocks ``spec`` gives each device (a copy
        each, on its device)."""
        spec = tuple(spec)
        if len(spec) != x.dim():
            raise ValueError(f"spec {spec} for a {x.dim()}-d tensor")
        for d, a in enumerate(spec):
            if a is not None and x.shape[d] % mesh.shape[a]:
                raise ValueError(
                    f"dim {d} of size {x.shape[d]} does not split over mesh "
                    f"axis {a!r} of {mesh.shape[a]}")
        blocks = np.empty(mesh.devices.shape, dtype=object)
        for c in _coords(mesh):
            blocks[c] = _local_part(x, spec, x.shape, mesh, c).clone(
                memory_format=torch.contiguous_format)
        return cls(blocks, mesh, spec)

    # -- what a tensor reports ------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return self.shape.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.flat[0].dtype

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where a plain operand made for this
        tensor goes before each block takes its part)."""
        return self.blocks.flat[0].device

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, spec={self.spec}, "
                f"dtype={self.dtype}, mesh={self.mesh.shape})")

    def __bool__(self):
        raise TypeError("the truth value of a ShardedTensor is ambiguous")

    def __array__(self, *a, **k):
        raise TypeError("a ShardedTensor has no host array: gather() it first")

    __hash__ = object.__hash__

    def __getattr__(self, name):
        # a Tensor attribute with no local form here (``is_cuda``, for the
        # flat NTT's dispatch): refused, as an unknown torch function is
        if not name.startswith("_") and hasattr(torch.Tensor, name):
            raise NotImplementedError(
                f"Tensor.{name} has no local form on a ShardedTensor: the "
                f"whole-tensor op would read across a sharded dim; run it "
                f"per block (shard_map) or through parallel/sharded_ntt.py")
        raise AttributeError(name)

    # -- the local map ----------------------------------------------------------

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HANDLERS:
            return _HANDLERS[func](*args, **kwargs)
        if func in _ELEMENTWISE:
            return _elementwise(func, args, kwargs)
        _refuse(getattr(func, "__name__", str(func)))

    def map_blocks(self, fn, out_spec=None) -> "ShardedTensor":
        """``fn(block, coordinate)`` for every block; ``out_spec`` (default
        this one's) is the result's."""
        blocks = np.empty(self.mesh.devices.shape, dtype=object)
        for c in _coords(self.mesh):
            blocks[c] = fn(self.blocks[c], c)
        return ShardedTensor(blocks, self.mesh, self.spec if out_spec is None else out_spec)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default :attr:`device`): one
        all-gather."""
        dev = self.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for c in _coords(self.mesh):
            blk = self.blocks[c]
            idx = tuple(
                slice(None) if a is None else slice(
                    _axis_index(self.mesh, a, c) * blk.shape[d],
                    (_axis_index(self.mesh, a, c) + 1) * blk.shape[d])
                for d, a in enumerate(self.spec))
            out[idx] = blk.to(dev)
        if any(a and self.mesh.shape[a] > 1 for a in self.spec):
            count("all-gather")
        return out

    # -- structural ops, local where no sharded dim is read across -------------

    def __getitem__(self, idx):
        items = idx if isinstance(idx, tuple) else (idx,)
        consumed = sum(1 for i in items if i is not None and i is not Ellipsis)
        if sum(1 for i in items if i is Ellipsis) > 1:
            raise IndexError("an index can only have a single ellipsis")
        fill = (slice(None),) * (self.ndim - consumed)
        if any(i is Ellipsis for i in items):
            k = next(j for j, i in enumerate(items) if i is Ellipsis)
            items = items[:k] + fill + items[k + 1 :]
        else:
            items = items + fill
        out_spec, d = [], 0
        for i in items:
            if i is None:
                out_spec.append(None)
                continue
            if isinstance(i, bool) or not isinstance(i, (int, np.integer, slice)):
                _refuse(f"indexing by {type(i).__name__}")
            a = self.spec[d]
            if a is not None and i != slice(None):
                _refuse("indexing a sharded dim")
            if isinstance(i, slice):
                out_spec.append(a)
            d += 1
        return self.map_blocks(lambda b, c: b[items], tuple(out_spec))

    def reshape(self, *shape) -> "ShardedTensor":
        """Local where every sharded dim keeps its place: the dims from it
        to the end, or from the start to it, unchanged."""
        shape = _sizes(shape)
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            shape[shape.index(-1)] = self.numel() // known
        if int(np.prod(shape)) != self.numel():
            raise RuntimeError(f"shape {shape} is invalid for {tuple(self.shape)}")
        out_spec, local = [None] * len(shape), list(shape)
        for d, a in enumerate(self.spec):
            if a is None:
                continue
            tail = self.ndim - d
            if tail <= len(shape) and tuple(self.shape[d:]) == tuple(shape[len(shape) - tail :]):
                e = len(shape) - tail
            elif d < len(shape) and tuple(self.shape[: d + 1]) == tuple(shape[: d + 1]):
                e = d
            else:
                _refuse("a reshape that splits or merges a sharded dim")
            out_spec[e] = a
            local[e] = shape[e] // self.mesh.shape[a]
        return self.map_blocks(lambda b, c: b.reshape(local), tuple(out_spec))

    def expand(self, *sizes) -> "ShardedTensor":
        sizes = _sizes(sizes)
        off = len(sizes) - self.ndim
        local = []
        for e, s in enumerate(sizes):
            d = e - off
            if d >= 0 and self.spec[d] is not None:
                if s not in (-1, self.shape[d]):
                    _refuse("expanding a sharded dim")
                local.append(-1)
            else:
                local.append(s)
        return self.map_blocks(lambda b, c: b.expand(local),
                               (None,) * off + self.spec)

    def squeeze(self, dim: int) -> "ShardedTensor":
        d = _dim(dim, self.ndim)
        if self.spec[d] is not None:
            _refuse("squeezing a sharded dim")
        return self.map_blocks(lambda b, c: b.squeeze(d),
                               self.spec[:d] + self.spec[d + 1 :])

    def index_select(self, dim: int, index: torch.Tensor) -> "ShardedTensor":
        d = _dim(dim, self.ndim)
        if self.spec[d] is not None:
            _refuse("index_select along a sharded dim")
        return self.map_blocks(
            lambda b, c: b.index_select(d, index.to(b.device)))

    def to(self, *args, **kwargs) -> "ShardedTensor":
        if any(isinstance(x, (torch.device, str)) for x in (*args, *kwargs.values())):
            raise NotImplementedError(
                "a ShardedTensor's blocks stay on their devices: gather() it")
        return _elementwise(torch.Tensor.to, (self, *args), kwargs)


_DUNDERS = (
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__and__", "__rand__", "__or__", "__ror__", "__xor__", "__rxor__",
    "__rshift__", "__lshift__", "__ge__", "__gt__", "__le__", "__lt__",
    "__eq__", "__ne__", "__neg__", "__invert__",
)


def _method(name):
    f = getattr(torch.Tensor, name)
    return lambda self, *a: _elementwise(f, (self, *a), {})


for _name in _DUNDERS:
    setattr(ShardedTensor, _name, _method(_name))

# what torch calls when a plain tensor meets a ShardedTensor (``p - x`` is
# ``Tensor.sub(p, x)``), and the torch functions the evaluator calls on one
_ELEMENTWISE = frozenset(
    [getattr(torch.Tensor, n) for n in _DUNDERS + (
        "add", "sub", "mul", "ne", "lt", "gt", "le", "eq", "ge")]
    + [torch.where, torch.zeros_like]
)

_HANDLERS = {
    torch.cat: _cat,
    torch.stack: _stack,
    torch.squeeze: ShardedTensor.squeeze,
    torch.index_select: ShardedTensor.index_select,
}


# ---------------------------------------------------------------------------
# Collectives over a sharded last dim.
# ---------------------------------------------------------------------------

def gather_index(x: ShardedTensor, index: torch.Tensor, n_tail: int,
                 out_tail: Tuple[int, ...]) -> ShardedTensor:
    """A permutation across the shards of ``x``'s last dim: the trailing
    ``n_tail`` dims of ``x`` read flat (global row-major order) and the
    result's trailing ``out_tail`` dims flat satisfy
    ``out_flat[j] = x_flat[index[j]]``; the result is sharded on its last
    dim over the same mesh axis.  One all-gather of the shards (each device
    assembles the whole trailing block once), a local ``index_select`` of
    the device's own output slice, no other traffic."""
    a = x.spec[-1]
    if a is None or any(s is not None for s in x.spec[-n_tail:-1]):
        raise ValueError("gather_index permutes a tensor sharded on its last dim only")
    k, mesh = x.mesh.shape[a], x.mesh
    width = out_tail[-1] // k
    fulls, blocks = {}, np.empty(mesh.devices.shape, dtype=object)
    for c in _coords(mesh):
        dev = mesh.devices[c]
        group = (_along(mesh, a, c, 0), dev)
        if group not in fulls:
            whole = torch.cat(
                [x.blocks[_along(mesh, a, c, q)].to(dev) for q in range(k)], dim=-1)
            fulls[group] = whole.reshape(*whole.shape[: whole.dim() - n_tail], -1)
        whole = fulls[group]
        i = _axis_index(mesh, a, c)
        sel = index.to(dev).reshape(out_tail)[..., i * width : (i + 1) * width]
        blk = whole.index_select(-1, sel.reshape(-1))
        blocks[c] = blk.reshape(*blk.shape[:-1], *out_tail[:-1], width)
    if k > 1:
        count("all-gather")
    lead = x.spec[: x.ndim - n_tail]
    return ShardedTensor(blocks, mesh, lead + (None,) * (len(out_tail) - 1) + (a,))


@functools.lru_cache(maxsize=None)
def _roll_pieces(i: int, width: int, seg: int, shift: int) -> Tuple[Tuple[int, int, int], ...]:
    """Where block ``i`` of :func:`roll_segments` (blocks of ``width``)
    takes its output from: ``(source block, offset, length)`` per
    contiguous piece, in order.  Host work, done once per shape and shift
    (not in every call, nor in a replay of a staged call)."""
    g = i * width + np.arange(width)
    src = g - g % seg + (g % seg + shift) % seg
    breaks = np.flatnonzero((np.diff(src) != 1) | (np.diff(src // width) != 0)) + 1
    return tuple((int(src[run[0]]) // width, int(src[run[0]]) % width, len(run))
                 for run in np.split(np.arange(width), breaks))


def roll_segments(x: ShardedTensor, seg: int, shift: int) -> ShardedTensor:
    """``torch.roll(.., -shift)`` inside each run of ``seg`` consecutive
    entries of ``x``'s sharded last dim: ``out[j] = x[b + (j - b + shift) %
    seg]`` with ``b = j - j % seg``.  Each block assembles its output from
    the contiguous pieces it needs, taken from at most a few neighbours:
    one collective-permute where a piece crosses blocks."""
    a = x.spec[-1]
    mesh = x.mesh
    k = mesh.shape[a] if a else 1
    width = x.shape[-1] // k
    moved = False
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for c in _coords(mesh):
        dev, i = mesh.devices[c], _axis_index(mesh, a, c)
        pieces = []
        for q, off, length in _roll_pieces(i, width, seg, shift):
            moved |= q != i
            src_blk = x.blocks[_along(mesh, a, c, q)] if a else x.blocks[c]
            pieces.append(src_blk[..., off : off + length].to(dev))
        blocks[c] = torch.cat(pieces, dim=-1)
    if moved:
        count("collective-permute")
    return ShardedTensor(blocks, mesh, x.spec)


# ---------------------------------------------------------------------------
# Collectives along one mesh axis, on the blocks of a limb-sharded stack.
# ``blocks`` is an object array of the mesh's shape, one tensor per device;
# a group is the blocks that differ only in their ``axis`` coordinate.
# ---------------------------------------------------------------------------

def _groups(mesh: Mesh, axis: Optional[str]) -> List[list]:
    """The coordinates of each group along ``axis``, in axis order (every
    block its own group when ``axis`` is None)."""
    if axis is None:
        return [[c] for c in _coords(mesh)]
    pos = mesh.axis_names.index(axis)
    out: Dict[tuple, list] = {}
    for c in _coords(mesh):
        out.setdefault(c[:pos] + c[pos + 1 :], []).append(c)
    return list(out.values())


def _spans(mesh: Mesh, axis: Optional[str]) -> bool:
    return axis is not None and mesh.shape[axis] > 1


def all_gather_dim(blocks: np.ndarray, mesh: Mesh, axis: Optional[str],
                   dim: int) -> np.ndarray:
    """All-gather of one dim along ``axis``: every block gets its group's
    blocks concatenated along ``dim`` in axis order, on its own device
    (computed once per device of a group).  Blocks may differ in their size
    along ``dim``; an empty one adds nothing, so this also hands one
    block's tensor to its whole group.  One all-gather."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for group in _groups(mesh, axis):
        done: Dict[torch.device, torch.Tensor] = {}
        for c in group:
            dev = mesh.devices[c]
            if dev not in done:
                done[dev] = torch.cat([blocks[q].to(dev) for q in group], dim=dim)
            out[c] = done[dev]
    if _spans(mesh, axis):
        count("all-gather")
    return out


def all_reduce_mod(blocks: np.ndarray, mesh: Mesh, axis: Optional[str],
                   p: torch.Tensor, lazy: bool) -> np.ndarray:
    """Modular all-reduce along ``axis``: every block gets the sum mod
    ``p`` of its group's blocks, added in axis order, on its own device
    (so every block of a group holds the same integers).  ``p`` broadcasts
    against a block (a ``[rows, 1]`` column).  ``lazy``: blocks and sum in
    ``[0, 2p)`` (a raw add and one conditional subtraction of 2p a term;
    every prime below 2**30), else canonical (modular adds).  The sum is
    congruent to a sum of the same terms in any other order, not always
    the same representative: a consumer that reduces fully sees no
    difference.  A row of modulus 2**16 is summed mod 2**16 exactly (its
    terms below 2**16, or 2**17 lazily; 2**16 is no prime, but an add and a
    conditional subtraction are exact mod any modulus): the BFV multiply
    stacks the m_tilde sum of its q -> Bsk conversion into the Bsk sums as
    such a row (``behz.conv_moduli``), so one all-reduce carries both.
    The blocks move as they are given, in either format; the sum is a
    chain in the working format of ``ops/modops.py`` and is returned in
    it.  One all-reduce."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for group in _groups(mesh, axis):
        done: Dict[torch.device, torch.Tensor] = {}
        for c in group:
            dev = mesh.devices[c]
            if dev not in done:
                pd = modops.wide(p.to(dev))
                p2 = pd + pd
                acc = modops.wide(blocks[group[0]].to(dev))
                for q in group[1:]:
                    x = blocks[q].to(dev)
                    acc = (modops.reduce_2p(modops.add_raw(acc, x), p2) if lazy
                           else modops.mod_add(acc, x, pd))
                done[dev] = acc
            out[c] = done[dev]
    if _spans(mesh, axis):
        count("all-reduce")
    return out


def rebalance(blocks: np.ndarray, mesh: Mesh, axis: Optional[str],
              dim: int) -> np.ndarray:
    """Even out a dim split unevenly along ``axis`` (block i of a group
    holds the next ``blocks[i].shape[dim]`` entries, in axis order) into
    equal consecutive blocks, each assembled from the pieces of the blocks
    that hold its entries; a block whose entries stay in place is kept as
    it is.  One collective-permute where a piece crosses blocks, none
    where nothing moves.  Raises ``NotImplementedError`` where the dim
    does not split evenly (``ShardedTensor`` holds equal blocks only;
    ``parallel/limb.py:_settle`` replicates such a stack instead)."""
    out = np.empty(mesh.devices.shape, dtype=object)
    moved = False
    for group in _groups(mesh, axis):
        sizes = [blocks[c].shape[dim] for c in group]
        total, k = sum(sizes), len(group)
        if total % k:
            raise NotImplementedError(
                f"{total} limbs do not split into {k} equal blocks over mesh "
                f"axis {axis!r}: a level the limb axis does not divide")
        width = total // k
        starts = np.concatenate([[0], np.cumsum(sizes)])
        for i, c in enumerate(group):
            lo, hi = i * width, (i + 1) * width
            if (starts[i], starts[i + 1]) == (lo, hi):
                out[c] = blocks[c]
                continue
            dev, pieces = mesh.devices[c], []
            for j, q in enumerate(group):
                a, b = max(lo, int(starts[j])), min(hi, int(starts[j + 1]))
                if a < b:
                    moved |= j != i
                    pieces.append(
                        blocks[q].narrow(dim, a - int(starts[j]), b - a).to(dev))
            out[c] = torch.cat(pieces, dim=dim) if len(pieces) > 1 else pieces[0]
    if moved:
        count("collective-permute")
    return out
