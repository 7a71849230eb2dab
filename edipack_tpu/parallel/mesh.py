"""Multi-device sharding of the sector matvec.

Design (SURVEY.md §2.4): the reference's MPI decomposition of the normal-mode
matvec shards the dw index of V[iup, idw] across ranks and alternates layouts
with an MPI_AlltoAllV vector transpose (ED_HAMILTONIAN_NORMAL_COMMON.f90:
66-167). Here V[ph, dw, up] carries a NamedSharding over the 'dw'
mesh axis; `V @ Hupᵀ` is embarrassingly local, and the dw-contraction
`Hdw @ V` lowers to XLA collectives inserted by GSPMD (an all-gather in the
compiled matvec, not the reference's all-to-all) — implicit in the sharding
propagation, not hand-written.

A second mesh axis 'sec' batches independent small sectors (the reference
runs sectors serially; here they are data-parallel).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, sec_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with axes ('sec', 'dw'): 'dw' shards a sector's dw dimension
    (tensor parallel), 'sec' runs independent sectors/sites in parallel
    (data parallel)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    sec_axis = max(1, min(sec_axis, n))
    while n % sec_axis:
        sec_axis -= 1
    arr = np.array(devs).reshape(sec_axis, n // sec_axis)
    return Mesh(arr, ("sec", "dw"))


def sector_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of a sector tensor V[ph, dw, up]: dw sharded over devices."""
    return NamedSharding(mesh, P(None, "dw", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_kron_matvec(mv, mesh: Mesh):
    """Install the dw sharding on a KronMatvec's operand pytree."""
    sh = sector_sharding(mesh)
    rep = replicated(mesh)
    row_sh = NamedSharding(mesh, P("dw", None))
    row_split = {"d", "eph_d", "d_lo", "eph_d_lo"}
    mv.ops = {name: jax.device_put(arr, row_sh if name in row_split else rep)
              for name, arr in mv.ops.items()}
    mv._sharding = sh
    return mv


def joint_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of a joint-sector tensor V[ph, el]: el rows sharded."""
    return NamedSharding(mesh, P(None, "dw"))


def shard_joint_matvec(mv, mesh: Mesh):
    """Row-split a JointMatvec's padded-ELL tables over the 'dw' mesh axis.

    Sharded form of the reference's superc/nonsu2 1-D row decomposition
    (ED_SUPERC/ED_HAMILTONIAN_SUPERC_STORED_HxV.f90:366-432): each device
    owns a contiguous block of electronic rows of (cols, vals); the input
    vector gather `take(v, cols, axis=1)` makes GSPMD insert the all-gather
    of v (the MPI_Allgatherv equivalent), after which the ELL
    contraction is local. Phonon/e-ph operators stay replicated (they act on
    the un-sharded phonon axis or via an el-contraction GSPMD reshards)."""
    import jax.numpy as jnp
    row_sh = NamedSharding(mesh, P("dw", None))
    rep = replicated(mesh)
    n_dw = mesh.shape["dw"]
    de = mv.cols.shape[0]
    dep = -(-de // n_dw) * n_dw
    if dep != de:
        # pad rows to a mesh multiple (device_put needs divisibility);
        # padded rows read v[0] with weight 0 and are sliced off in __call__
        pad = dep - de
        mv.cols = jnp.concatenate(
            [mv.cols, jnp.zeros((pad, mv.cols.shape[1]), mv.cols.dtype)])
        mv.vals = jnp.concatenate(
            [mv.vals, jnp.zeros((pad, mv.vals.shape[1]), mv.vals.dtype)])
    mv.cols = jax.device_put(mv.cols, row_sh)
    mv.vals = jax.device_put(mv.vals, row_sh)
    if getattr(mv, "has_ph", False):
        mv.ph_mat = jax.device_put(mv.ph_mat, rep)
        mv.ph_x = jax.device_put(mv.ph_x, rep)
        mv.eph_diag = jax.device_put(mv.eph_diag, rep)
        if mv.eph_dense is not None:
            mv.eph_dense = jax.device_put(mv.eph_dense, rep)
    mv._el_padded = dep
    return mv
