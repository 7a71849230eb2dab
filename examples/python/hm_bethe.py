#!/usr/bin/env python
"""Hubbard model on the Bethe lattice — single-band DMFT loop.

The canonical first DMFT calculation (the counterpart of the reference's
``examples/fortran/hm_bethe.f90`` / ``examples/cpp/hm_bethe.cpp``): the
semicircular density of states of the infinite-coordination Bethe lattice
makes the self-consistency closed-form,

    Delta(iw) = (D/2)^2 * G_loc(iw),   G_loc = G_imp,

so each iteration is: solve the impurity -> build the new hybridization
from G_imp -> chi^2-fit the bath to it -> mix -> repeat to convergence.

Run:  python hm_bethe.py            (reads inputED.conf if present)
      python hm_bethe.py uloc=4.0   (CLI overrides, reference syntax)

Outputs G_imp / Sigma on the Matsubara axis as text files in ./ plus a
convergence log, like the reference example.
"""
import os
import sys

import numpy as np

import jax

from edipack_tpu import (ed_chi2_fitgf, ed_get_dens, ed_get_gimp,
                         ed_get_sigma, ed_init_solver, ed_read_input,
                         ed_set_hloc, ed_solve)
from edipack_tpu.utils.jax_cache import enable_compile_cache

# the default JAX device runs the loop; HM_BETHE_CPU=1 pins the host CPU
# (uncached, as the CPU test suite: see tests/conftest.py)
if os.environ.get("HM_BETHE_CPU", "0") == "1":
    jax.config.update("jax_platforms", "cpu")
else:
    enable_compile_cache()

# ---- model / loop parameters ---------------------------------------------
WBAND = 1.0          # half-bandwidth D of the semicircular DOS
WMIX = 0.5           # linear mixing of the hybridization

cfg = ed_read_input("inputED.conf" if os.path.exists("inputED.conf")
                    else "inputED.in", argv=sys.argv[1:])

wm = (2 * np.arange(cfg.lmats) + 1) * np.pi / cfg.beta   # Matsubara grid

bath = ed_init_solver(cfg=cfg)
ed_set_hloc(np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb)))

delta_prev = None
for iloop in range(cfg.nloop):
    ed_solve(bath)

    # Bethe self-consistency: Delta = (D/2)^2 G_imp
    gimp = ed_get_gimp(axis="m")            # (Nspin,Nspin,Norb,Norb,Lmats)
    delta = (WBAND / 2.0) ** 2 * gimp
    if delta_prev is not None:
        delta = WMIX * delta + (1.0 - WMIX) * delta_prev

    # convergence on the hybridization (reference check_convergence on
    # the Weiss field)
    err = (1.0 if delta_prev is None else
           float(np.sum(np.abs(delta - delta_prev))
                 / max(np.sum(np.abs(delta)), 1e-15)))
    dens = ed_get_dens()
    print(f"loop {iloop + 1:3d}  err {err:.3e}  dens {dens[0]:.6f}",
          flush=True)
    delta_prev = delta
    if err < cfg.dmft_error:
        break

    # fit the bath to the new hybridization on the fit window
    bath = ed_chi2_fitgf(delta[0, 0][..., :cfg.lfit], bath, ispin=1)

# ---- outputs (reference-style text files) --------------------------------
gimp = ed_get_gimp(axis="m")[0, 0, 0, 0]
sigma = ed_get_sigma(axis="m")[0, 0, 0, 0]
np.savetxt("impG_iw.ed",
           np.column_stack([wm, gimp.imag, gimp.real]))
np.savetxt("impSigma_iw.ed",
           np.column_stack([wm, sigma.imag, sigma.real]))
print(f"done: dens={ed_get_dens()[0]:.6f}; wrote impG_iw.ed impSigma_iw.ed")
