"""Mixed-precision (double-single f32) matvec path + exact Rayleigh-Ritz
refinement (ed_mixed_matvec=always): large-sector Lanczos runs on a
split-f32 matvec (MixedKronMatvec) and the converged subspace is
re-diagonalized with exact f64 matvecs."""
import numpy as np
import pytest
import jax.numpy as jnp

from edipack_tpu.config import default_config
from edipack_tpu.bath.dmft_bath import init_bath
from edipack_tpu.models.normal import build_normal_sector_op
from edipack_tpu.ops.matvec import KronMatvec, MixedKronMatvec
from edipack_tpu.sectors import SectorTable
from edipack_tpu.solver.core import solve_impurity
from edipack_tpu.umatrix import build_umatrix


def _problem(**over):
    cfg = default_config(norb=2, nbath=3, nspin=1, uloc=[1.7, 1.7], ust=0.9,
                         jh=0.15, jx=0.1, jp=0.1, xmu=0.23, lmats=16, **over)
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    hloc = np.zeros((1, 1, 2, 2))
    hloc[0, 0] = np.array([[0.1, 0.05], [0.05, -0.1]])
    return cfg, hloc, um, bath


@pytest.mark.slow
def test_mixed_matvec_accuracy():
    cfg, hloc, um, bath = _problem()
    table = SectorTable(cfg)
    ns = table.dims.ns
    sec = table.by_qn(("n", (ns // 2,), (ns // 2,)))
    op = build_normal_sector_op(cfg, sec, hloc, um, bath)
    exact = KronMatvec(op, dtype=jnp.float64)
    mixed = MixedKronMatvec(op)
    rng = np.random.default_rng(0)
    v = rng.normal(size=exact.dim)
    v /= np.linalg.norm(v)
    w_ref = np.asarray(exact(jnp.asarray(v)))
    w_mix = np.asarray(mixed(jnp.asarray(v)))
    scale = np.abs(w_ref).max()
    assert np.abs(w_mix - w_ref).max() / scale < 5e-6
    assert w_mix.dtype == np.float64


@pytest.mark.slow
def test_mixed_solve_matches_exact():
    """Full solve with ed_mixed_matvec='always' (forces the split path even
    on CPU and for every Lanczos sector) must reproduce the exact-f64 solve
    to golden tolerance thanks to the f64 subspace refinement."""
    base = dict(lanc_dim_threshold=256)   # force Lanczos on medium sectors
    cfg_x, hloc, um, bath = _problem(ed_mixed_matvec="never", **base)
    res_x = solve_impurity(cfg_x, hloc, um, bath)

    cfg_m, _, _, _ = _problem(ed_mixed_matvec="always", **base)
    res_m = solve_impurity(cfg_m, hloc, um, bath)

    assert abs(res_x.e0 - res_m.e0) < 1e-8, abs(res_x.e0 - res_m.e0)
    assert np.allclose(res_x.dens, res_m.dens, atol=1e-7)
    assert np.allclose(res_x.obs.docc, res_m.obs.docc, atol=1e-7)
    # GF stays exact-f64 by default (ed_mixed_gf False): poles from the
    # refined states, moments from exact tridiag
    g_x = res_x.get_gimp()
    g_m = res_m.get_gimp()
    assert np.allclose(g_x, g_m, atol=5e-6), np.abs(g_x - g_m).max()


def test_exact_ell_matvec_is_f64_exact():
    """ExactKronMatvec (sparse-ELL f64 factor application) must match the dense f64 KronMatvec to f64 rounding, including
    phonon and nonlocal terms."""
    from edipack_tpu.ops.matvec import ExactKronMatvec
    from edipack_tpu.sectors import SectorTable
    for kw in (dict(norb=2, nbath=3, nspin=1, uloc=[1.7, 1.7], ust=0.9,
                    jh=0.15, jx=0.1, jp=0.1, xmu=0.23),
               dict(norb=2, nbath=2, nspin=1, uloc=[1.5, 1.4], ust=0.7,
                    jh=0.1, jx=0.08, jp=0.06, nph=2, w0_ph=0.5,
                    g_ph=[0.2, 0.15])):
        cfg = default_config(**kw)
        um = build_umatrix(cfg)
        bath = init_bath(cfg)
        hloc = np.zeros((1, 1, 2, 2))
        hloc[0, 0] = [[0.1, 0.05], [0.05, -0.1]]
        table = SectorTable(cfg)
        ns = table.dims.ns
        sec = table.by_qn(("n", (ns // 2,), (ns // 2,)))
        op = build_normal_sector_op(cfg, sec, hloc, um, bath)
        ref = KronMatvec(op, dtype=jnp.float64)
        ex = ExactKronMatvec(op)
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.normal(size=ref.dim))
        w0 = np.asarray(ref(v))
        w1 = np.asarray(ex(v))
        assert np.abs(w1 - w0).max() < 1e-14 * np.abs(w0).max()
