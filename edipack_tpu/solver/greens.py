"""Dynamical Green's functions via Krylov continued fractions.

Parity target: reference ED_GREENS_FUNCTIONS.f90 + ED_GF_NORMAL.f90
(build_impG_normal :68+, add_to_lanczos_gf_normal :363-427, off-diagonal
reconstruction :540-563, evaluation get_impG :496-607, Dyson get_Sigma
:698-739) and the GFmatrix store (ED_GFMATRIX.f90:26-55).

For every retained eigenstate and excitation operator O the engine computes
|φ> = O|ψ>, tridiagonalizes H in the target sector (on-device Lanczos, no
reorth — reference lanc_ngfiter moments) or, for small target sectors, uses
the exact dense eigenbasis, and accumulates Källén-Lehmann weights/poles.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import EDConfig
from ..sectors import Sector, SectorTable
from ..ops.lanczos import lanczos_tridiag
from ..ops.sector_ops import spin_axis_op
from .eigenspace import StateList


@dataclass
class GFMatrix:
    """Flat Källén-Lehmann store: channel key -> (weights, poles) with the
    state Boltzmann weights folded in. G_key(z) = Σ_n w_n / (z - p_n)."""
    channels: Dict[Tuple, List[Tuple[np.ndarray, np.ndarray]]] = field(
        default_factory=dict)

    def add(self, key: Tuple, weights: np.ndarray, poles: np.ndarray) -> None:
        self.channels.setdefault(key, []).append(
            (np.asarray(weights, dtype=complex), np.asarray(poles, float)))

    def packed(self, key: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        if key not in self.channels:
            return np.zeros(0, complex), np.zeros(0)
        ws = np.concatenate([w for w, _ in self.channels[key]])
        ps = np.concatenate([p for _, p in self.channels[key]])
        return ws, ps

    def eval(self, key: Tuple, z: np.ndarray) -> np.ndarray:
        w, p = self.packed(key)
        z = np.atleast_1d(np.asarray(z, complex))
        if len(w) == 0:
            return np.zeros(len(z), complex)
        den = z[:, None] - p[None, :]
        # exact z == pole hits (the nu=0 bosonic point against an elastic
        # p=0 excitation): exclude the singular terms instead of emitting
        # inf/nan into the whole grid
        sing = den == 0
        if np.any(sing):
            den = np.where(sing, 1.0, den)
            return (np.where(sing, 0.0, w[None, :]) / den).sum(axis=1)
        return (w[None, :] / den).sum(axis=1)

    def eval_tau(self, key: Tuple, tau: np.ndarray, beta: float
                 ) -> np.ndarray:
        """Fermionic imaginary-time evaluation on 0 <= tau <= beta:
        G(tau) = -Σ_n w_n e^{-tau p_n} / (1 + e^{-beta p_n}), computed in
        the overflow-stable logaddexp form."""
        w, p = self.packed(key)
        tau = np.atleast_1d(np.asarray(tau, float))
        if len(w) == 0:
            return np.zeros(len(tau))
        ex = -np.logaddexp(tau[:, None] * p[None, :],
                           (tau[:, None] - beta) * p[None, :])
        return -(np.real(w)[None, :] * np.exp(ex)).sum(axis=1)

    # -- persistence (reference write/read_GFmatrix, ED_GFMATRIX.f90:78-107)
    def save(self, path: str) -> None:
        payload = {}
        for key, lst in self.channels.items():
            skey = repr(key)
            payload[skey + "|w"] = np.concatenate([w for w, _ in lst])
            payload[skey + "|p"] = np.concatenate([p for _, p in lst])
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str) -> "GFMatrix":
        from ast import literal_eval
        data = np.load(path)
        gf = cls()
        for name in data.files:
            if name.endswith("|w"):
                key = literal_eval(name[:-2])
                gf.add(key, data[name], data[name[:-2] + "|p"])
        return gf


# ---------------------------------------------------------------------------


def _moments_from_phi(matvec, phi, m: int, dense_eig=None):
    """Excitation moments: returns (weights, excitation energies E_n).

    dense_eig = (evals, evecs) exact eigenbasis of the target sector when
    available (small sectors); otherwise on-device Lanczos tridiag + host
    eigh of the small tridiagonal matrix."""
    if dense_eig is not None:
        evals, evecs = dense_eig
        amps = np.asarray(jnp.conj(evecs.T) @ phi) if hasattr(evecs, "shape") \
            else evecs.T.conj() @ np.asarray(phi)
        w = np.abs(amps) ** 2
        keep = w > 1e-16 * max(w.max(), 1e-300)
        return w[keep], np.asarray(evals)[keep]
    dim = phi.shape[0]
    if dim <= 128:
        # tiny target sector: exact moments via materialized H (avoids
        # per-shape jit churn of the scan-based tridiag); internal-layout
        # operators (real-embedded joint mixed, fused) are driven through
        # their to/from_internal_flat boundary
        if hasattr(matvec, "to_internal_flat"):
            apply = getattr(matvec, "exact", None) or matvec
            eye = np.eye(dim, dtype=complex)
            h = np.stack([
                np.asarray(matvec.from_internal_flat(apply(
                    matvec.to_internal_flat(jnp.asarray(eye[i])))))
                for i in range(dim)], axis=1)
        else:
            eye = jnp.eye(dim, dtype=phi.dtype)
            h = np.stack([np.asarray(matvec(eye[i]))
                          for i in range(dim)], axis=1)
        evals, evecs = np.linalg.eigh(h)
        amps = evecs.conj().T @ np.asarray(phi)
        w = np.abs(amps) ** 2
        keep = w > 1e-16 * max(w.max(), 1e-300)
        return w[keep], evals[keep]
    m = max(2, m)
    if hasattr(matvec, "to_internal_flat"):
        # blocked-layout operator (models.joint_kron): Krylov runs in its
        # internal layout; the conversion is a norm-preserving
        # permutation+padding
        phi = matvec.to_internal_flat(jnp.asarray(phi))
    if hasattr(matvec, "pair") and getattr(matvec, "ds_recurrence_ok", True):
        # double-single operator: f32 recurrence + f64-accumulated dots
        # (ops.lanczos.lanczos_tridiag_ds)
        from ..ops.lanczos import lanczos_tridiag_ds
        alphas, betas, norm0 = lanczos_tridiag_ds(matvec, phi, m)
    else:
        alphas, betas, norm0 = lanczos_tridiag(matvec, phi, m)
    a = np.asarray(alphas)
    b = np.asarray(betas)
    n0 = float(norm0)
    if n0 < 1e-15:
        return np.zeros(0), np.zeros(0)
    # truncate at breakdown
    k = m
    for i in range(m - 1):
        if b[i] < 1e-13 * max(1.0, np.abs(a).max()):
            k = i + 1
            break
    t = np.diag(a[:k])
    if k > 1:
        t += np.diag(b[:k - 1], 1) + np.diag(b[:k - 1], -1)
    tv, tu = np.linalg.eigh(t)
    w = (n0 ** 2) * np.abs(tu[0, :]) ** 2
    return w, tv


def _tridiag_moments_host(a, b, n0, m):
    """Weights/energies from one fetched (alphas, betas, norm0) chain."""
    if n0 < 1e-15:
        return np.zeros(0), np.zeros(0)
    k = m
    for i in range(m - 1):
        if b[i] < 1e-13 * max(1.0, np.abs(a).max()):
            k = i + 1
            break
    t = np.diag(a[:k])
    if k > 1:
        t += np.diag(b[:k - 1], 1) + np.diag(b[:k - 1], -1)
    tv, tu = np.linalg.eigh(t)
    return (n0 ** 2) * np.abs(tu[0, :]) ** 2, tv


def _moments_from_phis(matvec, phis, m: int):
    """Batched Lanczos moments: all ``phis`` target the SAME sector, so the
    B tridiagonal chains run in ONE vmapped launch
    (ops.lanczos.lanczos_tridiag_batch); the small (B, m) tridiagonals are
    solved host-side. Falls back to per-phi launches for internal-layout
    (blocked-Kron) operators."""
    from ..ops.lanczos import (lanczos_tridiag_batch, lanczos_tridiag_ds_batch,
                               _j_stack)
    m = max(2, m)
    if len(phis) == 1 or hasattr(matvec, "to_internal_flat"):
        return [_moments_from_phi(matvec, phi, m) for phi in phis]
    use_ds = hasattr(matvec, "pair") and getattr(matvec,
                                                 "ds_recurrence_ok", True)
    dim = int(np.prod(np.asarray(phis[0]).shape))
    # chunk so the batched scan's live vectors (~4 per chain) stay bounded
    max_b = max(2, int((1 << 28) // max(1, 4 * dim * 16)))
    out = []
    for lo in range(0, len(phis), max_b):
        chunk = phis[lo:lo + max_b]
        if len(chunk) == 1:
            out.append(_moments_from_phi(matvec, chunk[0], m))
            continue
        v0s = _j_stack([jnp.asarray(p).reshape(-1) for p in chunk])
        if use_ds:
            alphas, betas, norm0s = lanczos_tridiag_ds_batch(matvec, v0s, m)
        else:
            alphas, betas, norm0s = lanczos_tridiag_batch(matvec, v0s, m)
        a = np.asarray(alphas)
        b = np.asarray(betas)
        n0 = np.asarray(norm0s)
        out.extend(_tridiag_moments_host(a[i], b[i], float(n0[i]), m)
                   for i in range(len(chunk)))
    return out


def build_gf_normal(cfg: EDConfig, table: SectorTable, sl: StateList,
                    matvec_builder: Callable[[Sector], object],
                    dense_eig_cache: Callable[[int], Optional[Tuple]],
                    all_g: bool = True) -> GFMatrix:
    """Normal-mode impurity GF. Channel keys:
    ('g', ispin, a, b) for G_ab^s; weights folded with state weights.
    Off-diagonal components are produced directly as the symmetrized
    combination (reference :540-563)."""
    gf = GFMatrix()
    weights = sl.boltzmann_weights()
    norb, nspin = cfg.norb, cfg.nspin
    per_orbital_qn = not cfg.ed_total_ud
    # per-orbital QNs forbid inter-orbital mixing -> G_ab(a!=b) = 0 exactly
    offdiag = (cfg.ed_solve_offdiag_gf or cfg.bath_type != "normal") \
        and not per_orbital_qn

    # aux store for off-diagonal reconstruction
    aux = GFMatrix()

    # Lanczos channels accumulate ACROSS states per target sector and flush
    # as one batched launch each (same design as the joint-mode
    # _GfHarvester); items: (store, key, phi, wstate, sgn, ei)
    pending: Dict[int, list] = {}

    for istate, st in enumerate(sl):
        wstate = weights[istate]
        isec = st.sector
        sec = table.sector(isec)
        v3 = jnp.reshape(st.vector, (sec.dim_ph, sec.dim_dw, sec.dim_up))
        ei = st.energy
        for ispin in range(nspin):
            axis = 2 if ispin == 0 else 1
            basis_src = sec.ups if ispin == 0 else sec.dws
            # --- particle (c†) and hole (c) target sectors
            for sgn_kind, kind in ((+1, "cdg"), (-1, "c")):
                jsec_of = {}
                for a in range(norb):
                    iud = a if per_orbital_qn else 0
                    jsec_of[a] = (table.cdg_sector(isec, ispin, iud)
                                  if kind == "cdg"
                                  else table.c_sector(isec, ispin, iud))
                phis = {}
                targets = {}
                for a in range(norb):
                    if jsec_of[a] is None:
                        continue
                    tsec = table.sector(jsec_of[a])
                    basis_tgt = tsec.ups if ispin == 0 else tsec.dws
                    amap = spin_axis_op(basis_src, basis_tgt, sec.ns, kind, a,
                                        axis)
                    phis[a] = amap.apply(v3).reshape(-1)
                    targets[a] = tsec
                combos = [(a, a) for a in range(norb) if a in phis]
                if offdiag:
                    combos += [(a, b) for a in range(norb)
                               for b in range(a + 1, norb)
                               if a in phis and b in phis]
                # Lanczos channels queue grouped by target sector
                # (ed_total_ud=True: every orbital's c/cdg lands in the
                # same sector) and flush as batched launches below
                for (a, b) in combos:
                    phi = phis[a] if a == b else (phis[a] + phis[b])
                    jsec = jsec_of[a]
                    dense_eig = dense_eig_cache(jsec)
                    key = ("g", ispin, a, b) if a == b \
                        else ("aux", ispin, a, b)
                    store = gf if a == b else aux
                    if dense_eig is not None:
                        w, en = _moments_from_phi(None, phi, 2,
                                                  dense_eig=dense_eig)
                        if len(w):
                            store.add(key, wstate * w, sgn_kind * (en - ei))
                    else:
                        pending.setdefault(jsec, []).append(
                            (store, key, phi, wstate, sgn_kind, ei))

    for jsec, items in pending.items():
        tsec = table.sector(jsec)
        mv = matvec_builder(tsec)
        m = min(cfg.lanc_ngfiter, max(2, tsec.dim))
        res = _moments_from_phis(mv, [p for (_, _, p, _, _, _) in items], m)
        for (store, key, _, wstate, sgn_kind, ei), (w, en) in zip(items, res):
            if len(w):
                store.add(key, wstate * w, sgn_kind * (en - ei))

    # phonon displacement propagator channel (reference
    # lanc_build_gf_phonon_main, ED_GF_NORMAL.f90:278-345): X = b + b†
    # applied within the SAME sector
    if cfg.nph > 0:
        from ..models.normal import _phonon_matrices
        _, x = _phonon_matrices(cfg)
        xj = jnp.asarray(x)
        ph_pending: Dict[int, list] = {}
        for istate, st in enumerate(sl):
            sec = table.sector(st.sector)
            v3 = jnp.reshape(st.vector, (sec.dim_ph, sec.dim_dw, sec.dim_up))
            phi = jnp.einsum("pq,qdu->pdu", xj, v3)
            dense_eig = dense_eig_cache(st.sector)
            if dense_eig is not None:
                wts, en = _moments_from_phi(None, phi.reshape(-1), 2,
                                            dense_eig=dense_eig)
                if len(wts):
                    gf.add(("ph",), weights[istate] * wts, en - st.energy)
            else:
                ph_pending.setdefault(st.sector, []).append(
                    (phi.reshape(-1), weights[istate], st.energy))
        for jsec, items in ph_pending.items():
            tsec = table.sector(jsec)
            mv = matvec_builder(tsec)
            m = min(cfg.lanc_ngfiter, max(2, tsec.dim))
            res = _moments_from_phis(mv, [p for p, _, _ in items], m)
            for (_, wstate, e0), (wts, en) in zip(items, res):
                if len(wts):
                    gf.add(("ph",), wstate * wts, en - e0)

    # off-diagonal reconstruction: G_ab = (aux - G_aa - G_bb)/2
    if offdiag:
        for ispin in range(nspin):
            for a in range(norb):
                for b in range(a + 1, norb):
                    key = ("aux", ispin, a, b)
                    if key not in aux.channels:
                        continue
                    wA, pA = aux.packed(key)
                    waa, paa = gf.packed(("g", ispin, a, a))
                    wbb, pbb = gf.packed(("g", ispin, b, b))
                    w = np.concatenate([0.5 * wA, -0.5 * waa, -0.5 * wbb])
                    p = np.concatenate([pA, paa, pbb])
                    gf.add(("g", ispin, a, b), w, p)
                    gf.add(("g", ispin, b, a), w, p)
    return gf


def eval_gf_normal(cfg: EDConfig, gf: GFMatrix, z) -> np.ndarray:
    """G(z): (Nspin,Nspin,Norb,Norb,Lz) (spin-diagonal in normal mode)."""
    z = np.atleast_1d(np.asarray(z, complex))
    ns, no = cfg.nspin, cfg.norb
    out = np.zeros((ns, ns, no, no, len(z)), complex)
    for s in range(ns):
        for a in range(no):
            for b in range(no):
                out[s, s, a, b] = gf.eval(("g", s, a, b), z)
    return out


def eval_dimp(cfg: EDConfig, gf: GFMatrix, z, axis: str = "m") -> np.ndarray:
    """Phonon propagator D(z) with enforced spectral symmetry
    (reference get_impD_normal, ED_GF_NORMAL.f90:611-690)."""
    z = np.atleast_1d(np.asarray(z, complex))
    out = np.zeros(len(z), complex)
    w, p = gf.packed(("ph",))
    beta = cfg.beta
    for peso, de in zip(np.real(w), p):
        if abs(beta * de) < 1e-8:
            if axis.startswith("m"):
                out[np.abs(z) < 1e-10] -= peso * beta
            else:
                out[np.abs(np.real(z)) < 1e-10] += peso * beta
        elif de > 0:
            f = peso * (1.0 - np.exp(-beta * de))
            if axis.startswith("m"):
                out -= f * 2 * de / (np.imag(z) ** 2 + de ** 2)
            else:
                out += f * (1.0 / (z - de) - 1.0 / (z + de))
    return out


def sigma_normal(cfg: EDConfig, gf_eval: np.ndarray, invg0: np.ndarray) -> np.ndarray:
    """Σ = G0⁻¹ - G⁻¹ (reference get_Sigma_normal :698-739)."""
    from ..bath.functions import _block_inv
    ginv = _block_inv(gf_eval)
    return invg0 - ginv
