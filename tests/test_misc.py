"""Timing/trace subsystem, chemical-potential search, real-axis evaluation."""
import numpy as np

from edipack_tpu.config import default_config
from edipack_tpu.bath.dmft_bath import init_bath
from edipack_tpu.solver.core import solve_impurity
from edipack_tpu.solver.mu_search import reset_search, search_variable
from edipack_tpu.umatrix import build_umatrix


def _solve(cfg, xmu):
    um = build_umatrix(cfg.replace(xmu=xmu))
    bath = init_bath(cfg)
    return solve_impurity(cfg.replace(xmu=xmu), np.zeros((1, 1, 1, 1)), um, bath)


def test_timings_present():
    cfg = default_config(norb=1, nbath=2, nspin=1, uloc=[2.0])
    res = _solve(cfg, 0.1)
    assert "diagonalization" in res.timings
    assert "greens_functions" in res.timings
    assert res.timings["diagonalization"] > 0


def test_mu_search_converges_to_target_density():
    # finite T: n(mu) is continuous so any target is attainable (at T=0 the
    # finite-system density is a staircase)
    cfg = default_config(norb=1, nbath=2, nspin=1, uloc=[2.0], nread=1.3,
                         nerr=5e-3, ndelta=0.4, beta=5.0, ed_finite_temp=True,
                         lanc_nstates_total=64, lanc_nstates_sector=16)
    reset_search()
    xmu = 0.0
    for it in range(40):
        res = _solve(cfg, xmu)
        n = float(res.dens[0])
        xmu_new, conv = search_variable(cfg, xmu, n, False)
        if abs(cfg.nread - n) < cfg.nerr:
            break
        xmu = xmu_new
    assert abs(n - cfg.nread) < cfg.nerr, (n, xmu)


def test_real_axis_evaluation():
    cfg = default_config(norb=1, nbath=2, nspin=1, uloc=[2.0], xmu=0.1,
                         lreal=200, wini=-4, wfin=4, eps=0.05)
    res = _solve(cfg, 0.1)
    g = res.get_gimp(axis="r")
    assert g.shape[-1] == cfg.lreal
    # retarded: Im G(w+i0) < 0 everywhere; spectral weight integrates to ~1
    w = np.linspace(cfg.wini, cfg.wfin, cfg.lreal)
    aw = -np.imag(g[0, 0, 0, 0]) / np.pi
    assert np.all(aw > -1e-10)
    assert abs(np.trapezoid(aw, w) - 1.0) < 0.05
    s = res.get_sigma(axis="r")
    assert np.all(np.imag(s[0, 0, 0, 0]) < 1e-8)  # causal self-energy


def test_device_put_cplx_roundtrip():
    """Host -> device transfers of complex and real arrays
    (ops.matvec.device_put_cplx) are bit-exact in the requested dtype."""
    import numpy as np
    import jax.numpy as jnp
    from edipack_tpu.ops.matvec import device_put_cplx
    rng = np.random.default_rng(5)
    x = rng.normal(size=17) + 1j * rng.normal(size=17)
    for dt in (jnp.complex64, jnp.complex128):
        y = np.asarray(device_put_cplx(x, dt))
        assert y.dtype == np.dtype(dt)
        np.testing.assert_allclose(y, x.astype(np.dtype(dt)), rtol=0)
    r = np.asarray(device_put_cplx(np.arange(5.0), jnp.float32))
    assert r.dtype == np.float32


def test_lanczos_tridiag_batch_matches_single():
    import numpy as np
    import jax.numpy as jnp
    from edipack_tpu.ops.lanczos import lanczos_tridiag, lanczos_tridiag_batch
    rng = np.random.default_rng(2)
    n = 64
    h = rng.normal(size=(n, n))
    h = (h + h.T) / 2
    hj = jnp.asarray(h)

    def mv(v):
        return hj @ v
    v0s = jnp.asarray(rng.normal(size=(3, n)))
    ab, bb, nb = lanczos_tridiag_batch(mv, v0s, 12)
    for i in range(3):
        a1, b1, n1 = lanczos_tridiag(mv, v0s[i], 12)
        np.testing.assert_allclose(np.asarray(ab)[i], np.asarray(a1),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(bb)[i], np.asarray(b1),
                                   atol=1e-10)
        assert abs(float(nb[i]) - float(n1)) < 1e-10


def test_eigsh_huge_dim_f32_basis_storage(monkeypatch):
    """dim >= F32_BASIS_MIN_DIM stores the Krylov basis in f32 (device-memory
    fit for the largest sectors); eigenvalues stay accurate via the f64
    coefficients + exact Rayleigh-Ritz polish.  The threshold is lowered to
    2^20 here to keep the test's vectors small."""
    import numpy as np
    import jax.numpy as jnp
    from edipack_tpu.ops import lanczos
    from edipack_tpu.ops.lanczos import eigsh_lowest
    monkeypatch.setattr(lanczos, "F32_BASIS_MIN_DIM", 1 << 20)
    n = (1 << 20) + 64
    rng = np.random.default_rng(7)
    d = jnp.asarray(np.sort(rng.uniform(1.0, 5.0, size=n)))
    d = d.at[0].set(0.123456789)       # isolated lowest eigenvalue

    def mv(v):
        return d * v
    vals, vecs = eigsh_lowest(mv, n, 1, dtype=jnp.float64, m=24, tol=1e-9,
                              max_restarts=6, refine_matvec=mv)
    assert abs(float(vals[0]) - 0.123456789) < 1e-8
    # the Krylov basis is stored f32 internally; the POLISHED eigenvectors
    # come back upcast to the working f64 (post-r04 polish contract)
    assert vecs.dtype == jnp.float64
    # and without the refine pass, the raw reduced-precision vectors leak
    vals2, vecs2 = eigsh_lowest(mv, n, 1, dtype=jnp.float64, m=24, tol=1e-9,
                                max_restarts=6)
    assert vecs2.dtype == jnp.float32  # reduced-precision basis storage
