"""Distributed negacyclic NTT over a slot-sharded mesh.

Counterpart of ``reference_seal_backend_tpu/parallel/sharded_ntt.py``.  The
four-step layout of ``ops/ntt.py`` makes the coefficient axis shard
naturally: view the N coefficients as an ``[n1, n2 = 128]`` matrix and
shard its column axis, so every phase-1 stage pairs whole rows inside one
block; the mid-transform transpose is ONE all-to-all over the mesh axis
(each shard sends column block ``j`` of its transposed part to shard ``j``);
phase 2 pairs rows of the transposed matrix, local again, each shard
reading its slice of the twiddle planes.

Data convention (the reference's): :func:`fwd` takes the row-major matrix
view ``[..., l, n1, n2]`` sharded on its last axis and returns the
transposed layout ``[..., l, n2, n1]`` sharded on its last axis;
:func:`inv` takes that layout back.  Keeping the transposed layout between
the two saves two all-to-alls a round trip; pointwise ops do not care.
Blocks may come in either format of ``ops/modops.py`` (each is widened on
entry); every all-to-all moves storage, and the result is storage.

The local stages are ``ops/ntt.py``'s :func:`phase1` / :func:`phase2`, plain
PyTorch on CPU and CUDA tensors alike.  That is faithful: the reference
runs them as XLA code (its ``_bf_ct`` / ``_bf_gs``), not as its Pallas
kernel, so no TPU kernel lies on this path.  Their own CUDA kernel is
queued (ROADMAP H9).  The all-to-all is one ``.to(device,
non_blocking=True)`` copy per pair of shards and a concatenation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.ops.ntt import (
    phase1,
    phase2,
    reduce_epilogue,
    scale_n_inv,
)
from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.parallel.mesh import Mesh, ShardedTensor

#: Set to a dict to have :func:`fwd` / :func:`inv` note every distinct way
#: they are called: ``(id(plan), "ntt_fwd" | "ntt_inv", global shape, lo,
#: epilogue) -> plan``.  ``chip_smoke.py`` holds the sharded transforms
#: against the CUDA kernels on exactly those shapes.  None notes nothing.
call_log: Optional[dict] = None


def _transpose_a2a(x: ShardedTensor, axis: str) -> ShardedTensor:
    """``[..., R, C]`` (the columns of an ``R x C*k`` matrix sharded over
    ``axis``) -> ``[..., C*k, R/k]``: the columns of its transpose, sharded
    the same way.  Shard ``j`` receives from every shard ``i`` the rows
    ``[j R/k, (j+1) R/k)`` of ``i``'s block: one all-to-all."""
    mesh = x.mesh
    k = mesh.shape[axis]
    rows = x.blocks.flat[0].shape[-2] // k
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for c in mesh_mod._coords(mesh):
        j, dev = mesh_mod._axis_index(mesh, axis, c), mesh.devices[c]
        parts = [
            x.blocks[mesh_mod._along(mesh, axis, c, i)][..., j * rows : (j + 1) * rows, :]
            .to(dev, non_blocking=True)
            for i in range(k)
        ]
        blocks[c] = torch.cat(parts, dim=-1).transpose(-1, -2)
    if k > 1:
        mesh_mod.count("all-to-all", blocks.flat[0].numel() * blocks.flat[0].element_size())
    return ShardedTensor(blocks, mesh, x.spec)


def _check(x: ShardedTensor, mesh: Mesh, axis: str, batch_axes) -> None:
    want = (*batch_axes, *([None] * (x.ndim - 1 - len(batch_axes))), axis)
    if x.mesh is not mesh or x.spec != want:
        raise ValueError(
            f"sharded NTT input placed as {x.spec} on {x.mesh}, expected "
            f"{want} on {mesh}")


def fwd(plan, x: ShardedTensor, mesh: Mesh, axis: str = "sp", lo: int = 0,
        batch_axes: tuple = (), epilogue: bool = True) -> ShardedTensor:
    """Forward NTT of matrix-view residues ``[..., l, n1, n2]`` (limbs
    ``[lo, lo + l)`` of ``plan``), ``n2`` sharded over ``axis``, the leading
    dims over ``batch_axes``; returns the transposed layout ``[..., l, n2,
    n1]`` sharded on its last axis.  Bit-exact against the flat transform
    (``NttPlan.fwd_plain``), range contract included: lazy plans take
    inputs in ``[0, 2p)``, and ``epilogue=False`` returns the raw ``[0, 4p)``
    stage output."""
    _check(x, mesh, axis, batch_axes)
    if call_log is not None:
        call_log.setdefault((id(plan), "ntt_fwd", tuple(x.shape), lo, epilogue), plan)
    n1_loc = plan.n1 // mesh.shape[axis]
    x1 = x.map_blocks(lambda b, c: modops.narrow(
        phase1(plan, modops.wide(b), lo, inverse=False)))
    xt = _transpose_a2a(x1, axis)

    def second(b, c):
        col0 = mesh_mod._axis_index(mesh, axis, c) * n1_loc
        out = phase2(plan, modops.wide(b), lo, col0, inverse=False)
        if plan.lazy and epilogue:
            out = reduce_epilogue(plan, out, lo)
        return modops.narrow(out)

    return xt.map_blocks(second)


def inv(plan, xt: ShardedTensor, mesh: Mesh, axis: str = "sp", lo: int = 0,
        batch_axes: tuple = ()) -> ShardedTensor:
    """Inverse NTT from the transposed layout ``[..., l, n2, n1]`` (``n1``
    sharded) back to the matrix view ``[..., l, n1, n2]`` (``n2``
    sharded); canonical output."""
    _check(xt, mesh, axis, batch_axes)
    if call_log is not None:
        call_log.setdefault((id(plan), "ntt_inv", tuple(xt.shape), lo, None), plan)
    n1_loc = plan.n1 // mesh.shape[axis]
    y = xt.map_blocks(lambda b, c: modops.narrow(phase2(
        plan, modops.wide(b), lo,
        mesh_mod._axis_index(mesh, axis, c) * n1_loc, inverse=True)))
    x = _transpose_a2a(y, axis)
    return x.map_blocks(lambda b, c: modops.narrow(scale_n_inv(
        plan, phase1(plan, modops.wide(b), lo, inverse=True), lo)))


def shard_matrix_view(plan, x_flat: torch.Tensor, mesh: Mesh,
                      axis: str = "sp") -> ShardedTensor:
    """``[..., l, N]`` flat polynomials -> the matrix view ``[..., l, n1,
    n2]`` with the column axis sharded over ``axis``."""
    mat = x_flat.reshape(*x_flat.shape[:-1], plan.n1, plan.n2)
    return ShardedTensor.distribute(mat, mesh, (None,) * (mat.dim() - 1) + (axis,))
