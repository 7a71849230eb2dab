"""edipack_tpu — an accelerator exact-diagonalization engine for quantum
impurity problems (the capabilities of EDIpack, re-designed for JAX/XLA).

Design stance (vs the Fortran+MPI reference at EDIpack v6.1.0):

* Sector vectors in the *normal* mode are dense matrices ``V[DimDw, DimUp]``
  (× phonon axis) and every Hamiltonian term is a Kronecker factor
  ``A_up ⊗ B_dw``; the matvec is a handful of dense matmuls instead of the reference's row-loop CSR SpMV
  (cf. reference ED_NORMAL/ED_HAMILTONIAN_NORMAL_STORED_HxV.f90).
* superc/nonsu2 joint sectors use padded-ELL sparse matvec + dense fallback.
* Sector enumeration / term generation is vectorized host-side (NumPy / C++),
  everything on the solve path is jittable with static shapes.
* Multi-chip scaling shards the dw axis of V over a `jax.sharding.Mesh`;
  the reference's MPI_AlltoAllV "vector transpose" becomes an XLA collective
  inserted by GSPMD (cf. reference ED_HAMILTONIAN_NORMAL_COMMON.f90:66-167).

Public API mirrors the reference's Fortran/Python-facing surface
(`ed_init_solver`, `ed_solve`, `ed_get_sigma`, ... — reference EDIPACK.f90).
"""
import os

# f64 is required for Lanczos recurrences and 1e-8-grade observables
# (reference lanc_tolerance=1e-18, ED_INPUT_VARS.f90:731). Opt out with
# EDIPACK_TPU_NO_X64=1 before first import.
if not os.environ.get("EDIPACK_TPU_NO_X64"):
    import jax

    jax.config.update("jax_enable_x64", True)

from .version import __version__
from .config import EDConfig, ed_read_input, default_config, get_config, set_config
from .main import (
    EDSolver,
    ed_init_solver,
    ed_solve,
    ed_finalize_solver,
    ed_set_hloc,
    ed_get_bath_dimension,
    ed_get_sigma,
    ed_get_gimp,
    ed_get_g0imp,
    ed_get_dimp,
    ed_get_dens,
    ed_get_docc,
    ed_get_mag,
    ed_get_phi,
    ed_get_argphi,
    ed_get_exct,
    ed_get_eimp,
    ed_get_doubles,
    ed_get_evals,
    ed_get_neigen_sector,
    ed_set_neigen_sector,
    ed_get_chi,
    ed_get_rdm,
    ed_get_sp_dm,
    ed_get_quantum_soc_operators,
    ed_get_imp_info,
    ed_get_g0and,
    ed_get_delta,
    ed_chi2_fitgf,
    ed_add_twobody_operator,
    ed_reset_umatrix,
    ed_read_umatrix_file,
    ed_save_umatrix_file,
    ed_search_variable,
    ed_update_input,
    ed_check_convergence,
    ed_reset_convergence,
    ed_get_reduced_rdm,
    ed_get_spinchi,
    ed_get_denschi,
    ed_get_pairchi,
    ed_get_exctchi,
    ed_get_epot,
    ed_get_eint,
    ed_get_ehartree,
    ed_get_eknot,
    ed_get_ephon,
    ed_get_phon,
    ed_get_nsectors,
    ed_get_impurity_rdm,
    ed_get_denmat,
    ed_set_suffix,
    ed_reset_suffix,
    ed_set_g_ph,
    ed_set_a_ph,
    ed_read_impgmatrix,
    ed_read_impdmatrix,
    ed_read_spinchimatrix,
    ed_read_denschimatrix,
    ed_read_pairchimatrix,
    ed_read_exctchimatrix,
    ed_build_impg,
    ed_build_impf,
    ed_build_impd,
    ed_build_sigma,
    ed_build_self,
    ed_build_spinchi,
    ed_build_denschi,
    ed_build_pairchi,
    ed_build_exctchi,
    ed_build_krylov_state_complexity,
    ed_build_krylov_operator_complexity,
    ed_get_ksc,
    ed_get_ssc,
    ed_get_psc,
    ed_get_koc,
    ed_get_soc,
    ed_get_poc,
    ed_search_chemical_potential,
)
from .bath import (
    ed_set_hreplica,
    ed_set_hgeneral,
    ed_set_linit_hreplica,
    ed_set_linit_hgeneral,
    ed_set_hsym_hreplica,
    ed_set_hsym_hgeneral,
    ed_read_dmft_bath,
    ed_spin_symmetrize_bath,
    ed_orb_symmetrize_bath,
    ed_break_symmetry_bath,
    ed_orb_equality_bath,
    ed_ph_symmetrize_bath,
    ed_enforce_normal_bath,
    ed_ph_trans_bath,
    ed_save_array_as_bath,
)
from .ineq import EDIneqSolver

__all__ = [k for k in dir() if k.startswith("ed_") or k in
           ("EDConfig", "EDSolver", "EDIneqSolver", "__version__")]
