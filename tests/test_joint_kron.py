"""Blocked-Kronecker joint operator == sorted COO/ELL operator, exactly.

The blocked-Kron matvec (models/joint_kron.py) is the factorized
superc/nonsu2 Hamiltonian; its dense matrix, conjugated by the
sorted<->blocked permutation, must reproduce build_joint_sector_op's dense
matrix for every term class: pairing (Δ bath, deltasc, anomalous Hloc,
pair field), spin-flips (SOC blocks, in-plane fields, u-hybridization),
Jx/Jp, replica Nambu baths, phonons, sundry operators."""
import numpy as np
import jax.numpy as jnp
import pytest

from edipack_tpu.config import default_config
from edipack_tpu.bath.dmft_bath import init_bath
from edipack_tpu.models.joint import build_joint_sector_op
from edipack_tpu.models.joint_kron import build_joint_kron_op
from edipack_tpu.sectors import SectorTable
from edipack_tpu.umatrix import build_umatrix


def dense_sorted(kr):
    """Dense matrix of the blocked-Kron operator in the SORTED joint basis
    (columns through the to/from_internal_flat layout boundary — also
    exercises the padded internal layout)."""
    dim = kr.dim_ph * kr.dim_el
    cols = []
    for i in range(dim):
        e = np.zeros(dim, complex)
        e[i] = 1.0
        w = kr(kr.to_internal_flat(jnp.asarray(e)))
        cols.append(np.asarray(kr.from_internal_flat(w)))
    return np.stack(cols, axis=1)


def _hloc(cfg, soc=False):
    rng = np.random.default_rng(11)
    h = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb), complex)
    m = rng.normal(size=(cfg.norb, cfg.norb))
    for s in range(cfg.nspin):
        h[s, s] = (m + m.T) / 2
    if soc and cfg.nspin == 2:
        b = 0.1 * rng.normal(size=(cfg.norb, cfg.norb)) \
            + 0.1j * rng.normal(size=(cfg.norb, cfg.norb))
        h[0, 1] = b
        h[1, 0] = b.conj().T
    return h


def _compare(cfg, qn, hloc=None, hloc_anomalous=None):
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    table = SectorTable(cfg)
    sec = table.by_qn(qn)
    if hloc is None:
        hloc = _hloc(cfg, soc=(cfg.ed_mode == "nonsu2"))
    ref = build_joint_sector_op(cfg, sec, hloc, um, bath,
                                hloc_anomalous=hloc_anomalous)
    dense_ref = np.asarray(ref.to_dense())
    kr = build_joint_kron_op(cfg, sec, hloc, um, bath,
                             hloc_anomalous=hloc_anomalous)
    dev = np.abs(dense_sorted(kr) - dense_ref).max()
    assert dev < 1e-10, dev
    # layout round-trip (logical sorted size)
    rng = np.random.default_rng(0)
    nlog = kr.dim_ph * kr.dim_el
    v = rng.normal(size=nlog) + 1j * rng.normal(size=nlog)
    vi = kr.to_internal_flat(jnp.asarray(v))
    back = np.asarray(kr.from_internal_flat(vi))
    np.testing.assert_allclose(back, v, atol=1e-12)
    return kr


def test_superc_pairing_and_jxjp():
    cfg = default_config(norb=2, nbath=2, nspin=1, ed_mode="superc",
                         uloc=[-1.3, -1.1], ust=0.4, jh=0.2, jx=0.15,
                         jp=0.12, deltasc=0.1, xmu=0.2,
                         pair_field=[0.05, 0.03])
    _compare(cfg, ("sz", 0))
    _compare(cfg, ("sz", -1))
    _compare(cfg, ("sz", 2))


def test_superc_anomalous_hloc_and_hybrid_bath():
    cfg = default_config(norb=2, nbath=3, nspin=1, ed_mode="superc",
                         bath_type="hybrid", uloc=[-1.0, -0.8],
                         deltasc=0.07, xmu=-0.1)
    ha = np.array([[0.08, 0.03], [0.03, -0.05]], complex)
    _compare(cfg, ("sz", 1), hloc_anomalous=ha)


def test_superc_replica_nambu():
    from edipack_tpu.bath.user import ed_set_hreplica, clear_global_basis
    cfg = default_config(norb=1, nbath=2, nspin=1, ed_mode="superc",
                         bath_type="replica", uloc=[-1.5], deltasc=0.0)
    # Nambu basis: identity (levels) + tau_x (pairing)
    ops = np.zeros((2, 2, 2, 1, 1), complex)
    ops[0, 0, 0] = 1.0
    ops[0, 1, 1] = -1.0
    ops[1, 0, 1] = 1.0
    ops[1, 1, 0] = 1.0
    lam = np.array([[0.5, 0.2], [-0.4, 0.3]])
    basis = ed_set_hreplica(ops, lam)
    try:
        um = build_umatrix(cfg)
        bath = init_bath(cfg, basis=basis)
        table = SectorTable(cfg)
        sec = table.by_qn(("sz", 0))
        hloc = np.zeros((1, 1, 1, 1))
        ref = np.asarray(build_joint_sector_op(cfg, sec, hloc, um,
                                               bath).to_dense())
        kr = build_joint_kron_op(cfg, sec, hloc, um, bath)
        dev = np.abs(dense_sorted(kr) - ref).max()
        assert dev < 1e-10, dev
    finally:
        clear_global_basis()


def test_nonsu2_soc_fields_uhyb():
    cfg = default_config(norb=2, nbath=2, nspin=2, ed_mode="nonsu2",
                         uloc=[1.6, 1.4], ust=0.6, jh=0.25, jx=0.25, jp=0.25,
                         spin_field_x=[0.11, 0.07], spin_field_y=[0.05, 0.0],
                         spin_field_z=[0.04, -0.03], xmu=0.3)
    _compare(cfg, ("nt", 4))
    _compare(cfg, ("nt", 3))


def test_nonsu2_exc_field_and_sundry():
    from edipack_tpu.umatrix import make_term
    cfg = default_config(norb=2, nbath=1, nspin=2, ed_mode="nonsu2",
                         uloc=[1.0, 1.0], exc_field=[0.06, 0.04, 0.03, 0.02])
    um = build_umatrix(cfg, runtime_terms=[
        make_term(1, "u", 2, "d", 1, "u", 2, "d", 0.3),
        make_term(1, "u", 2, "d", 2, "u", 1, "d", 0.15),
    ])
    bath = init_bath(cfg)
    table = SectorTable(cfg)
    sec = table.by_qn(("nt", 3))
    hloc = _hloc(cfg, soc=True)
    ref = np.asarray(build_joint_sector_op(cfg, sec, hloc, um,
                                           bath).to_dense())
    kr = build_joint_kron_op(cfg, sec, hloc, um, bath)
    dev = np.abs(dense_sorted(kr) - ref).max()
    assert dev < 1e-10, dev


def test_superc_phonons():
    cfg = default_config(norb=2, nbath=1, nspin=1, ed_mode="superc",
                         uloc=[-1.2, -1.0], deltasc=0.09, nph=2,
                         g_ph=[0.25, 0.2], w0_ph=0.6)
    _compare(cfg, ("sz", 0))


@pytest.mark.parametrize("mode,kw", [
    ("superc", dict(nspin=1, uloc=[-1.4, -1.1], ust=0.3, deltasc=0.1,
                    xmu=0.2)),
    ("nonsu2", dict(nspin=2, uloc=[1.5, 1.3], ust=0.5, jh=0.2, jx=0.2,
                    jp=0.2, spin_field_x=[0.1, 0.05], xmu=0.4)),
])
def test_solve_with_blocked_kron_matches_ell(mode, kw):
    """Full solve through the blocked-Kron matvec == padded-ELL solve."""
    from edipack_tpu.solver.core import solve_impurity
    base = dict(norb=2, nbath=2, ed_mode=mode, beta=50.0, lmats=12,
                ed_verbose=0, lanc_dim_threshold=32, **kw)
    hloc = _hloc(default_config(**base), soc=(mode == "nonsu2"))
    res = {}
    for jk in ("never", "always"):
        cfg = default_config(**base, ed_joint_kron=jk)
        um = build_umatrix(cfg)
        bath = init_bath(cfg)
        res[jk] = solve_impurity(cfg, hloc, um, bath)
    a, b = res["never"], res["always"]
    assert abs(a.e0 - b.e0) < 1e-9, (a.e0, b.e0)
    np.testing.assert_allclose(np.asarray(a.dens), np.asarray(b.dens),
                               atol=1e-8)
    z = 1j * (2 * np.arange(12) + 1) * np.pi / 50.0
    np.testing.assert_allclose(np.asarray(a.get_gimp(z)),
                               np.asarray(b.get_gimp(z)), atol=1e-7)
    if mode == "superc":
        np.testing.assert_allclose(np.asarray(a.get_gimp(z, typ="a")),
                                   np.asarray(b.get_gimp(z, typ="a")),
                                   atol=1e-7)
        np.testing.assert_allclose(np.asarray(a.phisc), np.asarray(b.phisc),
                                   atol=1e-8)


def test_solve_mixed_joint_smoke():
    """FAST production-path smoke: the real-embedded MixedJointKron DS
    operator + f64 exact polish (ed_joint_kron/ed_mixed_matvec = always)
    end-to-end on a small superc problem, vs the exact ELL solve.  The
    full two-orbital matrix lives in the slow tier
    (test_solve_mixed_joint_full)."""
    from edipack_tpu.solver.core import solve_impurity
    base = dict(norb=1, nbath=2, ed_mode="superc", nspin=1, uloc=[-1.5],
                deltasc=0.12, xmu=0.1, beta=50.0, lmats=12, ed_verbose=0,
                lanc_dim_threshold=8)
    res = {}
    for jk, mm in (("never", "never"), ("always", "always")):
        cfg = default_config(**base, ed_joint_kron=jk, ed_mixed_matvec=mm)
        um = build_umatrix(cfg)
        bath = init_bath(cfg)
        res[jk] = solve_impurity(cfg, np.zeros((1, 1, 1, 1)), um, bath)
    a, b = res["never"], res["always"]
    assert abs(a.e0 - b.e0) < 1e-8, (a.e0, b.e0)
    z = 1j * (2 * np.arange(12) + 1) * np.pi / 50.0
    np.testing.assert_allclose(np.asarray(a.get_gimp(z)),
                               np.asarray(b.get_gimp(z)), atol=2e-5)
    np.testing.assert_allclose(np.asarray(a.get_gimp(z, typ="a")),
                               np.asarray(b.get_gimp(z, typ="a")), atol=2e-5)


@pytest.mark.slow
@pytest.mark.parametrize("mode,kw", [
    ("superc", dict(nspin=1, uloc=[-1.4, -1.1], ust=0.3, deltasc=0.1,
                    xmu=0.2)),
    ("nonsu2", dict(nspin=2, uloc=[1.5, 1.3], ust=0.5, jh=0.2, jx=0.2,
                    jp=0.2, spin_field_x=[0.1, 0.05], xmu=0.4)),
])
def test_solve_mixed_joint_full(mode, kw):
    """ed_mixed_matvec=always joint path, full two-orbital matrix: the
    real-embedded DS operator through the whole solve (slow: every joint
    sector shape compiles its DS sweep/tridiag; jax caches are cleared
    between variants to dodge the jaxlib live-executable segfault)."""
    import jax
    from edipack_tpu.solver.core import solve_impurity
    base = dict(norb=2, nbath=2, ed_mode=mode, beta=50.0, lmats=12,
                ed_verbose=0, lanc_dim_threshold=32, **kw)
    hloc = _hloc(default_config(**base), soc=(mode == "nonsu2"))
    cfg = default_config(**base, ed_joint_kron="never")
    um = build_umatrix(cfg)
    a = solve_impurity(cfg, hloc, um, init_bath(cfg))
    za = np.asarray(a.get_gimp(1j * (2 * np.arange(12) + 1) * np.pi / 50.0))
    e0a, densa = a.e0, np.asarray(a.dens).copy()
    jax.clear_caches()
    cfg = default_config(**base, ed_joint_kron="always",
                         ed_mixed_matvec="always")
    um = build_umatrix(cfg)
    b = solve_impurity(cfg, hloc, um, init_bath(cfg))
    zb = np.asarray(b.get_gimp(1j * (2 * np.arange(12) + 1) * np.pi / 50.0))
    assert abs(e0a - b.e0) < 1e-8, (e0a, b.e0)
    np.testing.assert_allclose(densa, np.asarray(b.dens), atol=1e-6)
    np.testing.assert_allclose(za, zb, atol=2e-5)


def test_mixed_joint_kron_ds_parity():
    """MixedJointKron (real-embedded DS pair operator, no c128 operand):
    exact f64 real-split application == the c128 operator;
    the DS pair matches to ~1e-6; DS Lanczos + exact polish reaches f64
    eigenvalues WITHOUT J-duplicates (each complex state is a 2D real
    eigenspace, deflated via jmap)."""
    from edipack_tpu.ops.lanczos import eigsh_lowest
    cfg = default_config(norb=2, nbath=2, nspin=1, ed_mode="superc",
                         uloc=[-1.3, -1.1], ust=0.4, jh=0.2, jx=0.15,
                         jp=0.12, deltasc=0.1, xmu=0.2)
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    table = SectorTable(cfg)
    sec = table.by_qn(("sz", 0))
    hloc = _hloc(cfg)
    mv = build_joint_kron_op(cfg, sec, hloc, um, bath, mixed=True)
    ref = build_joint_kron_op(cfg, sec, hloc, um, bath)  # c128 (CPU)
    rng = np.random.default_rng(5)
    nlog = ref.dim_ph * ref.dim_el
    v = jnp.asarray(rng.normal(size=nlog) + 1j * rng.normal(size=nlog))
    w_ref = np.asarray(ref.from_internal_flat(ref(ref.to_internal_flat(v))))
    vi = mv.to_internal_flat(v)                 # real f64 stack
    w_ex = np.asarray(mv.from_internal_flat(mv.exact(vi)))
    assert np.abs(w_ex - w_ref).max() < 1e-11 * np.abs(w_ref).max()
    w_ds = np.asarray(mv.from_internal_flat(mv(vi)))
    assert np.abs(w_ds - w_ref).max() / np.abs(w_ref).max() < 1e-6
    # pair() on the f32 real stack
    m, c = mv.pair(vi.astype(jnp.float32))
    w_p = np.asarray(mv.from_internal_flat(
        (m + c).astype(jnp.float64)))
    assert np.abs(w_p - w_ref).max() / np.abs(w_ref).max() < 1e-6
    # jmap is the complex structure: exact(J v) == J exact(v)
    jv = np.asarray(mv.from_internal_flat(mv.exact(mv.jmap(vi))))
    np.testing.assert_allclose(jv, 1j * w_ex, atol=1e-10)
    # DS sweeps + exact refine: TWO lowest DISTINCT states, no J-duplicate
    dense = dense_sorted(ref)
    e_ref = np.linalg.eigvalsh(dense)[:2]
    vals, vecs = eigsh_lowest(mv, mv.dim, 2, dtype=jnp.float64, m=64,
                              tol=2e-6, max_restarts=12,
                              refine_matvec=mv.exact)
    assert abs(vals[0] - e_ref[0]) < 1e-9, (vals[0], e_ref[0])
    assert abs(vals[1] - e_ref[1]) < 1e-9, (vals[1], e_ref[1])
    # returned vectors map back to normalized complex states
    psi0 = np.asarray(mv.from_internal_flat(jnp.asarray(vecs[0])))
    assert abs(np.linalg.norm(psi0) - 1.0) < 1e-6


def test_joint_kron_sharded_mesh_parity():
    """Padded dw-sharded blocked-Kron (8-device mesh) == unsharded, exactly.

    The multi-chip fast path of the superc/nonsu2 matvec (VERDICT r03
    missing #2): blocks pad their dw axis to a mesh multiple and carry a
    NamedSharding; GSPMD inserts the all-gathers for the cross-block
    pairing gathers (reference ED_HAMILTONIAN_SUPERC_STORED_HxV.f90:366-432
    row split)."""
    import jax
    from edipack_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs the virtual multi-device mesh")
    cfg = default_config(norb=2, nbath=3, nspin=1, ed_mode="superc",
                         uloc=[-1.3, -1.1], ust=0.4, jh=0.2, jx=0.15,
                         jp=0.12, deltasc=0.1, xmu=0.2)
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    table = SectorTable(cfg)
    sec = table.by_qn(("sz", 0))
    hloc = _hloc(cfg)
    mesh = make_mesh(sec_axis=1)
    kr0 = build_joint_kron_op(cfg, sec, hloc, um, bath)
    kr8 = build_joint_kron_op(cfg, sec, hloc, um, bath, mesh=mesh)
    rng = np.random.default_rng(7)
    nlog = kr0.dim_ph * kr0.dim_el
    v = rng.normal(size=nlog) + 1j * rng.normal(size=nlog)
    f8 = jax.jit(lambda u: kr8.from_internal_flat(
        kr8(kr8.to_internal_flat(u))))
    w8 = np.asarray(f8(jnp.asarray(v)))
    w0 = np.asarray(kr0.from_internal_flat(kr0(kr0.to_internal_flat(
        jnp.asarray(v)))))
    np.testing.assert_allclose(w8, w0, atol=1e-11)
    # the padded operand really carries a non-replicated sharding
    shards = {s.device for s in kr8.diag_b[len(kr8.diag_b) // 2]
              .addressable_shards}
    assert len(shards) == len(jax.devices())
    # mixed + mesh compose
    krm = build_joint_kron_op(cfg, sec, hloc, um, bath, mesh=mesh,
                              mixed=True)
    fm = jax.jit(lambda u: krm.from_internal_flat(
        krm(krm.to_internal_flat(u))))
    wm = np.asarray(fm(jnp.asarray(v)))
    assert np.abs(wm - w0).max() / np.abs(w0).max() < 1e-6


def test_mixed_joint_exact_phonon_f64():
    """ADVICE r4: the 'exact' f64 path of MixedJointKron must use true f64
    phonon/e-ph operands (not astype'd f32/c64 copies) — compare against
    the c128 blocked-Kron operator on a superc + phonon sector."""
    cfg = default_config(norb=1, nbath=2, nspin=1, ed_mode="superc",
                         uloc=[-1.2], deltasc=0.15, xmu=0.1,
                         nph=2, w0_ph=0.437251, g_ph=[0.213731])
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    table = SectorTable(cfg)
    sec = table.by_qn(("sz", 0))
    hloc = np.zeros((1, 1, 1, 1))
    mv = build_joint_kron_op(cfg, sec, hloc, um, bath, mixed=True)
    ref = build_joint_kron_op(cfg, sec, hloc, um, bath)  # c128 on CPU
    rng = np.random.default_rng(3)
    nlog = ref.dim_ph * ref.dim_el
    v = jnp.asarray(rng.normal(size=nlog) + 1j * rng.normal(size=nlog))
    w_ref = np.asarray(ref.from_internal_flat(ref(ref.to_internal_flat(v))))
    w_ex = np.asarray(mv.from_internal_flat(mv.exact(mv.to_internal_flat(v))))
    # true f64 operands: error at the f64 rounding level, NOT ~1e-7
    assert np.abs(w_ex - w_ref).max() < 1e-12 * np.abs(w_ref).max()


def test_joint_solve_mixed_gf_false():
    """ADVICE r4: ed_mixed_gf=False with the MixedJointKron path must route
    GF moments through the exact operator's layout boundary (crashes before
    the fix); physics must match the exact ELL solve."""
    from edipack_tpu.solver.core import solve_impurity
    base = dict(norb=1, nbath=2, ed_mode="superc", nspin=1, uloc=[-1.5],
                deltasc=0.12, xmu=0.1, beta=50.0, lmats=12, ed_verbose=0,
                lanc_dim_threshold=8)
    cfg_ref = default_config(**base, ed_joint_kron="never")
    um = build_umatrix(cfg_ref)
    bath = init_bath(cfg_ref)
    a = solve_impurity(cfg_ref, np.zeros((1, 1, 1, 1)), um, bath)
    cfg = default_config(**base, ed_joint_kron="always",
                         ed_mixed_matvec="always", ed_mixed_gf=False)
    b = solve_impurity(cfg, np.zeros((1, 1, 1, 1)), um, bath)
    assert abs(a.e0 - b.e0) < 1e-8
    z = 1j * (2 * np.arange(12) + 1) * np.pi / 50.0
    np.testing.assert_allclose(np.asarray(a.get_gimp(z)),
                               np.asarray(b.get_gimp(z)), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.get_gimp(z, typ="a")),
                               np.asarray(b.get_gimp(z, typ="a")), atol=1e-6)
