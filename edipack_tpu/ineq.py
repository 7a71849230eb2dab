"""Inequivalent-impurities (real-space DMFT) batched solver.

Parity target: reference src/ineq (E2I_MAIN.f90): solve Nineq independent
impurity problems per DMFT iteration, with per-site interaction overrides
(`Uloc_ii`, `Ust_ii`, `Jh_ii`, `Jx_ii`, `Jp_ii`, E2I_MAIN.f90:174-178,
261-265), optional GF skip (`flag_gf`, :179), per-site Hloc
(E2I_AUX_FUNX ed_set_Hloc lattice overloads) and batched getters over the
leading Nineq axis (E2I_IO/*).

Design: sites are a leading batch axis; the per-site solves
share one process (the reference round-robins sites over MPI ranks,
E2I_MAIN.f90:253-296 — here small sectors already batch on-chip and the
mesh 'site' axis shards sites).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .config import EDConfig, get_config
from .main import EDSolver


class EDIneqSolver:
    """Batched solver over Nineq impurity sites."""

    def __init__(self, nineq: int, cfg: Optional[EDConfig] = None):
        self.nineq = nineq
        self.cfg = cfg or get_config()
        self.solvers = [EDSolver(self.cfg.replace(
            ed_file_suffix=f"_ineq{n+1:04d}")) for n in range(nineq)]

    def init_solver(self, baths: Optional[np.ndarray] = None) -> np.ndarray:
        out = []
        for n, s in enumerate(self.solvers):
            out.append(s.init_solver(None if baths is None else baths[n]))
        return np.stack(out)

    def set_hloc(self, hloc_ineq: np.ndarray) -> None:
        """Per-site Hloc: accepts a leading Nineq axis or a single Hloc
        replicated to every site (reference ed_set_Hloc lattice overloads)."""
        h = np.asarray(hloc_ineq)
        per_site = h.ndim >= 2 and h.shape[0] == self.nineq and (
            h.ndim == 5 or (h.ndim == 3 and h.shape[1] == h.shape[2]))
        for n, s in enumerate(self.solvers):
            s.set_hloc(h[n] if per_site else h)

    def solve(self, baths: Optional[np.ndarray] = None,
              uloc_ii: Optional[np.ndarray] = None,
              ust_ii: Optional[np.ndarray] = None,
              jh_ii: Optional[np.ndarray] = None,
              jx_ii: Optional[np.ndarray] = None,
              jp_ii: Optional[np.ndarray] = None,
              flag_gf: bool = True) -> List:
        """Solve every site; `*_ii` arrays override the input-file Kanamori
        couplings per site (reference E2I_MAIN.f90:261-265).

        Normal mode runs all sites as ONE batched sweep
        (solve_impurity_sites): every site's small sectors join the same
        padded eigh buckets, data-parallel over the device mesh — the
        batched form of the reference's site-over-ranks round robin.
        Joint modes (superc/nonsu2) fall back to the per-site loop."""
        for n, s in enumerate(self.solvers):
            over = {}
            if uloc_ii is not None:
                over["uloc"] = list(np.atleast_2d(uloc_ii)[n])
            if ust_ii is not None:
                over["ust"] = float(np.atleast_1d(ust_ii)[n])
            if jh_ii is not None:
                over["jh"] = float(np.atleast_1d(jh_ii)[n])
            if jx_ii is not None:
                over["jx"] = float(np.atleast_1d(jx_ii)[n])
            if jp_ii is not None:
                over["jp"] = float(np.atleast_1d(jp_ii)[n])
            if over:
                s.cfg = s.cfg.replace(**over)

        if self.cfg.ed_mode == "normal":
            return self._solve_batched(baths, flag_gf)
        results = []
        for n, s in enumerate(self.solvers):
            results.append(s.solve(None if baths is None else baths[n],
                                   flag_gf=flag_gf))
        return results

    def _solve_batched(self, baths, flag_gf: bool) -> List:
        from .bath.dmft_bath import array_to_bath
        from .solver.core import solve_impurity_sites
        from .umatrix import build_umatrix
        from . import io as edio
        cfgs, hlocs, ums, site_baths, neigens = [], [], [], [], []
        for n, s in enumerate(self.solvers):
            if baths is not None:
                s.bath = array_to_bath(baths[n], s.cfg, s.basis)
            cfgs.append(s.cfg)
            hlocs.append(s.hloc)
            ums.append(build_umatrix(s.cfg, runtime_terms=s.runtime_terms))
            site_baths.append(s.bath)
            neigens.append(s.result.diag.neigen_sector
                           if s.result is not None
                           and s.neigen_sector_override is None
                           else s.neigen_sector_override)
        results = solve_impurity_sites(self.cfg, hlocs, ums, site_baths,
                                       cfgs=cfgs,
                                       neigen_overrides=neigens,
                                       flag_gf=flag_gf)
        for n, s in enumerate(self.solvers):
            s.result = results[n]
            if s.cfg.ed_write_files:
                edio.write_all_outputs(s.cfg, s.result)
        return results

    def finalize(self) -> None:
        for s in self.solvers:
            s.finalize()

    # -- batched getters (reference E2I_IO) -----------------------------
    def _stack(self, fn):
        return np.stack([fn(s) for s in self.solvers])

    def get_sigma(self, zeta=None, axis="m", typ="n"):
        return self._stack(lambda s: s.result.get_sigma(zeta, axis, typ))

    def get_gimp(self, zeta=None, axis="m", typ="n"):
        return self._stack(lambda s: s.result.get_gimp(zeta, axis, typ))

    def get_g0imp(self, zeta=None, axis="m", typ="n"):
        return self._stack(lambda s: s.result.get_g0imp(zeta, axis, typ))

    def get_dimp(self, zeta=None, axis="m"):
        return self._stack(lambda s: s.result.get_dimp(zeta, axis))

    def get_chi(self, kind="spin", zeta=None, axis="m"):
        return self._stack(lambda s: s.result.get_chi(kind, zeta, axis))

    def get_dens(self):
        return self._stack(lambda s: s.result.dens)

    def get_docc(self):
        return self._stack(lambda s: s.result.docc)

    def get_mag(self, component: str = "z"):
        comp = {"x": 0, "y": 1, "z": 2}[component]
        return self._stack(lambda s: s.result.mag[comp])

    def get_phi(self):
        return self._stack(lambda s: s.result.phisc)

    def get_argphi(self):
        return self._stack(lambda s: s.result.argphi)

    def get_exct(self):
        return self._stack(lambda s: s.result.exct)

    def get_eimp(self):
        return self._stack(lambda s: s.result.energies)

    def get_doubles(self):
        return self._stack(lambda s: s.result.doubles)

    def get_evals(self):
        return [s.result.evals for s in self.solvers]

    def get_neigen_sector(self):
        return self._stack(lambda s: s.result.neigen_sector)

    def get_rdm(self):
        return self._stack(lambda s: s.result.get_rdm())

    def get_sp_dm(self):
        return self._stack(lambda s: s.result.single_particle_dm)

    def fit_gf(self, funcs, baths, ispin=1):
        from .bath.fit import chi2_fitgf
        out = []
        for n, s in enumerate(self.solvers):
            out.append(chi2_fitgf(s.cfg, funcs[n], baths[n], ispin=ispin,
                                  basis=s.basis))
        return np.stack(out)
