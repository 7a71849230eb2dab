"""Site-parallel ineq solve: the batched cross-site sweep
(solve_impurity_sites) must reproduce the serial per-site path exactly.

Runs on the 8-virtual-device CPU mesh (conftest), so the shared dense-eigh
buckets are genuinely sharded over devices with multiple sites per bucket —
the batched form of the reference's site-over-MPI-ranks round robin
(E2I_MAIN.f90:253-296)."""
import numpy as np

from edipack_tpu.config import default_config
from edipack_tpu.bath.dmft_bath import bath_to_array, init_bath
from edipack_tpu.umatrix import build_umatrix
from edipack_tpu.solver.core import solve_impurity, solve_impurity_sites


def _setup(nsites=3):
    cfg = default_config(norb=1, nbath=3, nspin=1, beta=60.0, uloc=[2.0],
                         xmu=1.0, lmats=24, ed_verbose=0,
                         ed_write_files=False)
    es = np.linspace(-0.2, 0.2, nsites)
    us = [2.0, 1.5, 2.5][:nsites]
    cfgs = [cfg.replace(uloc=[u], xmu=u / 2) for u in us]
    hlocs = [np.full((1, 1, 1, 1), e, complex) for e in es]
    ums = [build_umatrix(c) for c in cfgs]
    baths = [init_bath(c) for c in cfgs]
    return cfg, cfgs, hlocs, ums, baths


def test_batched_matches_serial():
    cfg, cfgs, hlocs, ums, baths = _setup()
    batched = solve_impurity_sites(cfg, hlocs, ums, baths, cfgs=cfgs)
    for s, c in enumerate(cfgs):
        serial = solve_impurity(c, hlocs[s], ums[s], baths[s])
        assert abs(batched[s].e0 - serial.e0) < 1e-10
        np.testing.assert_allclose(np.asarray(batched[s].dens),
                                   np.asarray(serial.dens), atol=1e-9)
        np.testing.assert_allclose(np.asarray(batched[s].docc),
                                   np.asarray(serial.docc), atol=1e-9)
        wn = 1j * (2 * np.arange(8) + 1) * np.pi / cfg.beta
        np.testing.assert_allclose(np.asarray(batched[s].get_gimp(wn)),
                                   np.asarray(serial.get_gimp(wn)),
                                   atol=1e-8)


def test_ineq_solver_uses_batched_path(tmp_path, monkeypatch):
    """EDIneqSolver.solve routes normal mode through solve_impurity_sites
    and keeps per-site U overrides + staggered Hloc physics."""
    monkeypatch.chdir(tmp_path)
    from edipack_tpu.ineq import EDIneqSolver
    cfg = default_config(norb=1, nbath=2, nspin=1, beta=40.0, uloc=[1.8],
                         xmu=0.9, lmats=16, ed_verbose=0,
                         ed_write_files=False)
    nineq = 2
    solver = EDIneqSolver(nineq, cfg)
    baths = np.stack([bath_to_array(init_bath(cfg))] * nineq)
    solver.init_solver(baths)
    hloc = np.zeros((nineq, 1, 1, 1, 1))
    hloc[0, 0, 0, 0, 0] = -0.15
    hloc[1, 0, 0, 0, 0] = +0.15
    solver.set_hloc(hloc)

    called = {}
    import edipack_tpu.solver.core as core
    orig = core.solve_impurity_sites

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(core, "solve_impurity_sites", spy)
    solver.solve(baths, uloc_ii=np.array([[1.8], [2.4]]))
    assert called.get("yes"), "batched site path not taken"
    dens = np.asarray(solver.get_dens()).ravel()
    assert dens[0] > dens[1]  # staggered Hloc
    # second solve consumes per-site neigen feedback without error
    solver.solve(baths)
    assert np.isfinite(np.asarray(solver.get_docc())).all()
