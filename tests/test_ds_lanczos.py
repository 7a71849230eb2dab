"""Double-single (f32-pair) Lanczos recurrences vs exact f64.

The DS paths (ops.lanczos.lanczos_tridiag_ds / lanczos_sweep_ds) are the
ed_mixed_matvec=always drivers: f32 recurrence vectors + f64-chunk-accumulated
inner products, fed by pair() operators (ops.matvec.MixedKronMatvec,
models.joint_kron.MixedJointKron).  Reference parity target: the GF
tridiagonalization and eigensolver of ED_GF_NORMAL.f90 /
ED_DIAG_NORMAL.f90 at its 1e-8-relative golden tolerances.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from edipack_tpu.config import default_config
from edipack_tpu.bath.dmft_bath import init_bath
from edipack_tpu.models.normal import build_normal_sector_op
from edipack_tpu.sectors import SectorTable
from edipack_tpu.umatrix import build_umatrix
from edipack_tpu.ops.matvec import KronMatvec, MixedKronMatvec
from edipack_tpu.ops.lanczos import (lanczos_tridiag, lanczos_tridiag_ds,
                                     lanczos_tridiag_ds_batch, eigsh_lowest,
                                     _dot64)


@pytest.fixture(scope="module")
def ops_pair():
    cfg = default_config(norb=2, nbath=2, nspin=1, uloc=[2.0, 2.0], ust=1.2,
                         jh=0.2, jx=0.15, jp=0.15)
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    hloc = np.zeros((1, 1, 2, 2))
    table = SectorTable(cfg)
    ns = table.dims.ns
    sec = table.by_qn(("n", (ns // 2,), (ns // 2,)))
    op = build_normal_sector_op(cfg, sec, hloc, um, bath)
    return KronMatvec(op, dtype=jnp.float64), MixedKronMatvec(op)


def test_dot64_accuracy():
    rng = np.random.default_rng(3)
    a = rng.normal(size=100_000).astype(np.float32)
    b = rng.normal(size=100_000).astype(np.float32)
    ref = np.dot(a.astype(np.float64), b.astype(np.float64))
    got = float(_dot64(jnp.asarray(a), jnp.asarray(b)))
    # error scale: ||a|| ||b|| (the dot itself may be arbitrarily cancelled)
    scale = np.linalg.norm(a) * np.linalg.norm(b)
    assert abs(got - ref) < 1e-7 * scale
    # norms (no cancellation) are relatively accurate
    na = float(_dot64(jnp.asarray(a), jnp.asarray(a)))
    assert abs(na - np.dot(a.astype(np.float64), a.astype(np.float64))) \
        < 1e-6 * na


def test_pair_matches_exact(ops_pair):
    exact, mixed = ops_pair
    rng = np.random.default_rng(0)
    v32 = jnp.asarray(rng.normal(size=mixed.dim).astype(np.float32))
    m, c = mixed.pair(v32)
    w_ds = np.asarray(m, np.float64) + np.asarray(c, np.float64)
    w_ex = np.asarray(exact(v32.astype(jnp.float64)))
    assert np.abs(w_ds - w_ex).max() / np.abs(w_ex).max() < 1e-6


def test_tridiag_ds_coefficients(ops_pair):
    exact, mixed = ops_pair
    rng = np.random.default_rng(1)
    v0 = jnp.asarray(rng.normal(size=mixed.dim))
    m = 40
    a_ex, b_ex, n_ex = lanczos_tridiag(exact, v0, m)
    a_ds, b_ds, n_ds = lanczos_tridiag_ds(mixed, v0, m)
    a_ex, b_ex = np.asarray(a_ex), np.asarray(b_ex)
    a_ds, b_ds = np.asarray(a_ds), np.asarray(b_ds)
    # Lanczos-without-reorth noise grows with the chain; the leading
    # coefficients (which set the GF moments) sit at the DS noise floor
    k = 15
    assert np.abs(a_ex[:k] - a_ds[:k]).max() / np.abs(a_ex[:k]).max() < 1e-4
    assert np.abs(b_ex[:k] - b_ds[:k]).max() / np.abs(b_ex[:k]).max() < 1e-4
    assert abs(float(n_ex) - float(n_ds)) / float(n_ex) < 1e-6
    assert a_ds.dtype == np.float64 and b_ds.dtype == np.float64


def test_tridiag_ds_batch(ops_pair):
    _, mixed = ops_pair
    rng = np.random.default_rng(2)
    v0s = jnp.asarray(rng.normal(size=(3, mixed.dim)))
    m = 12
    a, b, n0 = lanczos_tridiag_ds_batch(mixed, v0s, m)
    a1, b1, n1 = lanczos_tridiag_ds(mixed, v0s[1], m)
    assert np.allclose(np.asarray(a)[1], np.asarray(a1), atol=1e-10)
    assert np.allclose(np.asarray(n0)[1], float(n1), atol=1e-10)


def test_eigsh_ds_sweeps_with_exact_refine(ops_pair):
    """DS Lanczos sweeps + cluster polish must deliver f64 eigenvalues
    (the ed_mixed_matvec=always diagonalization path, ED_DIAG parity)."""
    exact, mixed = ops_pair
    vals_ds, vecs_ds = eigsh_lowest(mixed, mixed.dim, 2, dtype=jnp.float64,
                                    m=48, tol=2e-6, max_restarts=10,
                                    refine_matvec=exact)
    vals_ex, _ = eigsh_lowest(exact, exact.dim, 2, dtype=jnp.float64,
                              m=48, tol=1e-12, max_restarts=10)
    assert abs(vals_ds[0] - vals_ex[0]) < 1e-10
    assert abs(vals_ds[1] - vals_ex[1]) < 1e-10
    # returned vectors are f64 and normalized
    v0 = np.asarray(vecs_ds)[0]
    assert v0.dtype == np.float64
    assert abs(np.linalg.norm(v0) - 1.0) < 1e-8
    # eigen-residual at the exact operator
    r = np.asarray(exact(jnp.asarray(v0))) - vals_ds[0] * v0
    assert np.linalg.norm(r) < 1e-7
