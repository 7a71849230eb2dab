/* C API for edipack_tpu — the analog of the reference's
 * src/c_bindings/edipack_cbindings.h: lets C/C++/Fortran drivers run the
 * JAX solver. Implemented by libedipack_tpu_c.so (embedded CPython;
 * build with `make -C edipack_tpu/capi`).
 *
 * Array conventions follow the reference bindings: the packed bath vector is
 * the same layout as EDIpack's user bath array; Hloc is passed as
 * [Nspin*Norb x Nspin*Norb] row-major (real + imaginary parts); Green's
 * function / self-energy buffers are rank-5 [Nspin,Nspin,Norb,Norb,L]
 * row-major interleaved complex (re,im).
 */
#ifndef EDIPACK_TPU_CAPI_H
#define EDIPACK_TPU_CAPI_H

#ifdef __cplusplus
extern "C" {
#endif

/* lifecycle ---------------------------------------------------------- */
int  edtpu_init(void);                       /* start the runtime (idempotent) */
void edtpu_finalize(void);

int  edtpu_read_input(const char *path);     /* parse inputED-style file      */
int  edtpu_set_option_d(const char *name, double value);
int  edtpu_set_option_i(const char *name, long value);
int  edtpu_set_option_s(const char *name, const char *value);

int  edtpu_get_bath_dimension(void);
int  edtpu_init_solver(double *bath, int nb);          /* fills bath           */
int  edtpu_set_hloc(const double *re, const double *im, int nso);
int  edtpu_solve(const double *bath, int nb);

/* getters ------------------------------------------------------------ */
int  edtpu_get_dens(double *out, int norb);
int  edtpu_get_docc(double *out, int norb);
int  edtpu_get_eimp(double *out4);
int  edtpu_get_evals(double *out, int *n, int nmax);
/* Matsubara self-energy / GF on the default grid: out has
 * 2*Nspin*Nspin*Norb*Norb*L doubles (re,im interleaved, C order) */
int  edtpu_get_sigma_matsubara(double *out, int lmats);
int  edtpu_get_gimp_matsubara(double *out, int lmats);

/* chi2 bath fit: func = Weiss/Delta on Matsubara (same packing), bath is
 * updated in place */
int  edtpu_chi2_fitgf(const double *func, int l, double *bath, int nb,
                      int ispin);

/* extended statics (reference get_mag/doubles/phi/argphi/exct) ---------- */
int  edtpu_get_mag(const char *component, double *out, int norb);
int  edtpu_get_doubles(double *out4);
int  edtpu_get_phi(double *out, int n);      /* superc |phi| (Norb*Norb)   */
int  edtpu_get_argphi(double *out, int n);
int  edtpu_get_exct(double *out, int n);     /* exciton S0/Tx/Ty/Tz blocks */

/* dynamical functions on the default grid of the given axis:
 * axis = "m" (Matsubara) | "r" (real); typ = "n" (normal) | "a" (anomalous).
 * out: interleaved complex, C order, rank-5 [Nspin,Nspin,Norb,Norb,L]
 * (dimp: rank-1 [L]); nmax counts complex elements. */
int  edtpu_get_sigma_axis(const char *axis, const char *typ, double *out,
                          int nmax);
int  edtpu_get_gimp_axis(const char *axis, const char *typ, double *out,
                         int nmax);
int  edtpu_get_g0imp_axis(const char *axis, const char *typ, double *out,
                          int nmax);
int  edtpu_get_dimp_axis(const char *axis, double *out, int nmax);

/* susceptibilities: kind = "spin"|"dens"|"pair"|"exct_s0"|... ; out is
 * [Norb,Norb,L] interleaved complex */
int  edtpu_get_chi(const char *kind, const char *axis, double *out, int nmax);

/* impurity RDM (4^Norb square, interleaved complex); returns #elements */
int  edtpu_get_rdm(double *out, int nmax);
int  edtpu_get_sp_dm(double *out, int nmax);

/* runtime two-body operators (reference add_twobody_operator) ----------- */
int  edtpu_add_twobody_operator(int oi, int si, int oj, int sj, int ok,
                                int sk, int ol, int sl, double u);
int  edtpu_reset_umatrix(void);

/* replica/general matrix-basis baths (reference init_Hreplica/Hgeneral):
 * ops re/im are [Nsym,Nspin,Nspin,Norb,Norb] C-order; lam has nlam entries
 * (either Nsym, replicated, or Nbath*Nsym row-major) */
int  edtpu_set_hreplica(const double *re, const double *im, int nsym,
                        int nspin, int norb, const double *lam, int nlam,
                        int nbath);
int  edtpu_set_hgeneral(const double *re, const double *im, int nsym,
                        int nspin, int norb, const double *lam, int nlam,
                        int nbath);

/* solve with optional GF skip (reference solve_site flag_gf) ------------ */
int  edtpu_solve_flag(const double *bath, int nb, int flag_gf);

/* chemical-potential controller (reference ed_search_variable): var is
 * updated in place, *converged set to the still-converged flag */
int  edtpu_search_variable(double *var, double ntmp, int *converged);

/* inequivalent-impurities (lattice / R-DMFT, reference edipack2ineq) ---- */
int  edtpu_ineq_init(int nineq);
int  edtpu_ineq_init_solver(double *baths, int nineq, int nb); /* fills baths */
int  edtpu_ineq_set_hloc(const double *re, const double *im, int nso,
                         int per_site, int nineq);
int  edtpu_ineq_solve(const double *baths, int nineq, int nb, int flag_gf);
/* real-valued batched getters: name = "dens"|"docc"|"eimp"|"doubles"|...
 * returns #doubles written */
int  edtpu_ineq_get(const char *name, double *out, int nmax);
/* complex batched getters: name = "sigma"|"gimp"|"g0imp"; interleaved,
 * [Nineq,Nspin,Nspin,Norb,Norb,L]; returns #complex elements */
int  edtpu_ineq_get_gf(const char *name, double *out, int nmax);
int  edtpu_ineq_fit_gf(const double *funcs, int l, double *baths, int nineq,
                       int nb, int ispin);


/* bath-manipulation helpers (reference ED_BATH_USER / c-bindings
 * break_symmetry_bath_site etc.): operate on the packed bath in place ---- */
int  edtpu_break_symmetry_bath(double *bath, int nb, double field,
                               double sgn, int save);
int  edtpu_spin_symmetrize_bath(double *bath, int nb, int save);
int  edtpu_orb_symmetrize_bath(double *bath, int nb, int orb1, int orb2,
                               int save);
int  edtpu_orb_equality_bath(double *bath, int nb, int indx, int save);
int  edtpu_ph_symmetrize_bath(double *bath, int nb, int save);
int  edtpu_save_array_as_bath(const double *bath, int nb);

/* umatrix file IO (reference read/save_umatrix_file) -------------------- */
int  edtpu_read_umatrix_file(const char *path);
int  edtpu_save_umatrix_file(const char *path);

/* phonon couplings + observables (reference ed_set_g_ph/ed_get_phon) ---- */
int  edtpu_set_g_ph(const double *g, int norb);
int  edtpu_set_a_ph(double a);
int  edtpu_get_phon(double *x, double *x2);     /* <X>, <X^2> */
int  edtpu_get_ephon(double *eph, double *eeph);
int  edtpu_get_imp_info(double *out2);          /* [s2tot, egs] */
int  edtpu_get_neigen_sector(int *out, int *n, int nmax);

/* DMFT-loop helpers (reference dmft_error/nsuccess knobs) --------------- */
int  edtpu_check_convergence(const double *func, int n, double *err,
                             int *converged);
int  edtpu_reset_convergence(void);

/* per-site file suffix for inequivalent impurities (ed_set_suffix) ------ */
int  edtpu_set_suffix(int isite);
int  edtpu_reset_suffix(void);

const char *edtpu_last_error(void);

#ifdef __cplusplus
}
#endif
#endif /* EDIPACK_TPU_CAPI_H */
