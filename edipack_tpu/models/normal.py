"""Normal-mode sector Hamiltonian as Kronecker factors.

The reference assembles per-sector CSR blocks ``H = H_d ⊕ (I⊗H_up) ⊕ (H_dw⊗I)
⊕ H_nd ⊕ phonons`` and row-loops a sparse matvec
(ED_NORMAL/ED_HAMILTONIAN_NORMAL_STORED_HxV.f90). Here the sector vector is a
dense tensor ``V[DimPh, DimDw, DimUp]`` and *every* term is a Kronecker factor,
so the matvec is a handful of dense matmuls on small spin-factor matrices:

    H·V = D ⊙ V  +  V @ Hupᵀ  +  Hdw @ V  +  Σ_k B_k @ V @ A_kᵀ
        + ph_diag ⊙ V + X ⊗ (E·V)                           (phonon terms)

Term content parity (reference include trees ED_NORMAL/stored/):
  H_local.f90   -> D (density-density, Hartree, bath levels, fields)
  H_up/H_dw.f90 -> Hup/Hdw (imp hopping, bath hopping, hybridization, exc field)
  H_non_local   -> (A_k, B_k) Kronecker pairs (Jx spin exchange, Jp pair hop)
  H_sundry      -> generic op-strings, factorized per spin
  H_ph/H_e_ph   -> ph_mat (w0 b†b + A(b+b†)), X=(b+b†), E (g-weighted hops)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..bath.dmft_bath import DmftBath, bath_levels, bath_hyb
from ..config import EDConfig
from ..fock import bath_level, hop_elements, occupations
from ..sectors import Sector
from ..umatrix import SPIN_UP, SPIN_DW, OpString, Umatrix


@dataclass
class NormalSectorOp:
    """Host-side (NumPy) operator data for one (Nup,Ndw) sector; converted to
    device arrays by ops.matvec.KronMatvec.

    Nonlocal Kronecker pairs (A_k, B_k) are stored in permutation form
    ``nl_perm = (src_a, sgn_a, src_b, sgn_b)``: every c/c† operator-string
    spin factor has ≤1 nonzero per row, so A_k[u, src_a[k,u]] = sgn_a[k,u]
    (sgn 0 marks empty rows). Dense views materialize lazily via nl_a/nl_b
    (tests, dense-diag path) — never on the large-sector hot path."""
    sector: Sector
    d: np.ndarray                  # (DimDw, DimUp) diagonal
    hup: np.ndarray                # (DimUp, DimUp)
    hdw: np.ndarray                # (DimDw, DimDw)
    nl_perm: Optional[Tuple[np.ndarray, np.ndarray,
                            np.ndarray, np.ndarray]] = None
    # phonons (None when nph == 0)
    ph_mat: Optional[np.ndarray] = None    # (DimPh, DimPh) w0 b†b + A(b+b†)
    ph_x: Optional[np.ndarray] = None      # (DimPh, DimPh) displacement b+b†
    eph_d: Optional[np.ndarray] = None     # (DimDw, DimUp) diagonal of E
    eph_up: Optional[np.ndarray] = None    # (DimUp, DimUp) up part of E
    eph_dw: Optional[np.ndarray] = None    # (DimDw, DimDw) dw part of E

    @property
    def dim(self) -> int:
        return self.sector.dim

    @staticmethod
    def _perm_dense(src: np.ndarray, sgn: np.ndarray) -> np.ndarray:
        k, n = src.shape
        out = np.zeros((k, n, n))
        rows = np.arange(n)
        for i in range(k):
            out[i, rows, src[i]] = sgn[i]
        return out

    @property
    def nl_a(self) -> Optional[np.ndarray]:
        if self.nl_perm is None:
            return None
        if not hasattr(self, "_nl_a_dense"):
            self._nl_a_dense = self._perm_dense(self.nl_perm[0],
                                                self.nl_perm[1])
        return self._nl_a_dense

    @property
    def nl_b(self) -> Optional[np.ndarray]:
        if self.nl_perm is None:
            return None
        if not hasattr(self, "_nl_b_dense"):
            self._nl_b_dense = self._perm_dense(self.nl_perm[2],
                                                self.nl_perm[3])
        return self._nl_b_dense

    def nnz_estimate(self) -> int:
        """Effective sparse-matrix nonzeros (for nnz/s benchmark accounting)."""
        du, dd = self.hup.shape[0], self.hdw.shape[0]
        nnz = du * dd  # diagonal
        nnz += np.count_nonzero(self.hup) * dd + np.count_nonzero(self.hdw) * du
        if self.nl_perm is not None:
            src_a, sgn_a, src_b, sgn_b = self.nl_perm
            nnz += int((np.count_nonzero(sgn_a, axis=1)
                        * np.count_nonzero(sgn_b, axis=1)).sum())
        return int(nnz * (self.sector.dim_ph if self.ph_mat is None else 1))

    def to_dense(self) -> np.ndarray:
        """Materialize the full sector matrix (testing / dense-diag path)."""
        du, dd, dp = self.hup.shape[0], self.hdw.shape[0], self.sector.dim_ph
        iu, idw = np.eye(du), np.eye(dd)
        h = np.kron(idw, self.hup) + np.kron(self.hdw, iu)
        h += np.diag(self.d.reshape(-1))
        if self.nl_a is not None:
            for a, b in zip(self.nl_a, self.nl_b):
                h = h + np.kron(b, a)
        if dp == 1:
            return h
        ip = np.eye(dp)
        full = np.kron(ip, h) + np.kron(self.ph_mat, np.eye(du * dd))
        e_el = (np.kron(idw, self.eph_up) + np.kron(self.eph_dw, iu)
                + np.diag(self.eph_d.reshape(-1)))
        full += np.kron(self.ph_x, e_el)
        return full


# ---------------------------------------------------------------------------


def _hop_matrix(basis: np.ndarray, ns: int, terms: List[Tuple[int, int, float]],
                dim: int) -> np.ndarray:
    """Dense one-spin hopping matrix from (level_i, level_j, t) terms meaning
    t * c^+_i c_j (+ its own h.c. term supplied separately by the caller)."""
    h = np.zeros((dim, dim))
    for (i, j, t) in terms:
        if t == 0.0 or i == j:
            continue
        rows, cols, signs = hop_elements(basis, ns, i, j)
        np.add.at(h, (rows, cols), t * signs)
    return h


def _hop_perm(basis: np.ndarray, ns: int, i: int, j: int,
              t: float) -> Tuple[np.ndarray, np.ndarray]:
    """Permutation form (src, sgn) of t * c^+_i c_j on one spin basis:
    row r has its single nonzero at column src[r] with value sgn[r]."""
    dim = len(basis)
    src = np.zeros(dim, dtype=np.int32)
    sgn = np.zeros(dim)
    rows, cols, signs = hop_elements(basis, ns, i, j)
    src[rows] = cols
    sgn[rows] = t * signs
    return src, sgn


def _string_perm(basis: np.ndarray, ns: int, ops: List[Tuple[str, int]],
                 coeff: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Permutation form of a c/cdg operator string (identity when empty)."""
    dim = len(basis)
    if not ops:
        return np.arange(dim, dtype=np.int32), np.full(dim, coeff)
    from ..fock import apply_c, apply_cdg, state_index

    states = basis.copy()
    signs = np.ones(dim)
    valid = np.ones(dim, dtype=bool)
    for kind, lvl in ops:
        fn = apply_c if kind == "c" else apply_cdg
        states, s, v = fn(states, lvl)
        signs = signs * s
        valid &= v
    src = np.zeros(dim, dtype=np.int32)
    sgn = np.zeros(dim)
    cols = np.nonzero(valid)[0]
    rows = state_index(basis, states[cols])
    good = rows >= 0
    cols, rows = cols[good], rows[good]
    src[rows] = cols
    sgn[rows] = coeff * signs[cols]
    return src, sgn


def _string_matrix(basis: np.ndarray, ns: int,
                   ops: List[Tuple[str, int]]) -> Optional[np.ndarray]:
    """Dense matrix of a product of c/cdg operators applied in ``ops`` order
    (first entry acts first on the ket). Returns None for the identity."""
    if not ops:
        return None
    from ..fock import apply_c, apply_cdg, state_index

    dim = len(basis)
    states = basis.copy()
    signs = np.ones(dim)
    valid = np.ones(dim, dtype=bool)
    for kind, lvl in ops:
        fn = apply_c if kind == "c" else apply_cdg
        states, s, v = fn(states, lvl)
        signs = signs * s
        valid &= v
    m = np.zeros((dim, dim))
    cols = np.nonzero(valid)[0]
    rows = state_index(basis, states[cols])
    good = rows >= 0
    cols, rows = cols[good], rows[good]
    np.add.at(m, (rows, cols), signs[cols])
    return m


def _phonon_matrices(cfg: EDConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(ph_mat, X): w0 b†b + A(b+b†), and X = b + b† (reference H_ph.f90)."""
    dp = cfg.nph + 1
    n = np.arange(dp)
    x = np.zeros((dp, dp))
    sq = np.sqrt(np.arange(1, dp))
    x[np.arange(1, dp), np.arange(dp - 1)] = sq     # b†
    x[np.arange(dp - 1), np.arange(1, dp)] = sq     # b
    ph = np.diag(cfg.w0_ph * n) + cfg.a_ph * x
    return ph, x


def g_ph_matrix(cfg: EDConfig) -> np.ndarray:
    """Electron-phonon coupling matrix (Norb,Norb): diagonal from the g_ph
    input list, or read from GPHfile (reference ED_INPUT_VARS :626-629)."""
    if cfg.gphfile not in ("NONE", "", None):
        g = np.loadtxt(cfg.gphfile)
        g = np.asarray(g, dtype=np.float64).reshape(cfg.norb, cfg.norb)
        return g
    return np.diag(np.asarray(cfg.g_ph[: cfg.norb], dtype=np.float64))


# ---------------------------------------------------------------------------


def build_normal_sector_op(cfg: EDConfig, sec: Sector, hloc: np.ndarray,
                           um: Umatrix, bath: DmftBath) -> NormalSectorOp:
    """Assemble the Kronecker factors of one (Nup,Ndw) sector Hamiltonian.

    ``hloc``: (Nspin,Nspin,Norb,Norb) local impurity Hamiltonian (real parts
    used; normal mode forbids spin off-diagonal blocks)."""
    ns = sec.ns
    norb, nbath, nspin = cfg.norb, cfg.nbath, cfg.nspin
    isdw = nspin - 1  # reference uses impHloc(Nspin,Nspin,...) for the dw spin
    ups, dws = sec.ups, sec.dws
    du, dd = len(ups), len(dws)

    hloc = np.asarray(hloc)
    mf = um.mf_hloc
    h_up_imp = np.real(hloc[0, 0] + mf[0, 0])
    h_dw_imp = np.real(hloc[isdw, isdw] + mf[1, 1])
    if not cfg.ed_total_ud:
        offdiag_sources = [h_up_imp - np.diag(np.diag(h_up_imp)),
                           h_dw_imp - np.diag(np.diag(h_dw_imp)),
                           np.asarray(cfg.exc_field)]
        if any(np.any(np.abs(x) > 1e-13) for x in offdiag_sources):
            raise ValueError("ed_total_ud=False requires orbital-diagonal "
                             "Hloc and no exc_field (per-orbital N conservation)")
    if np.any(np.abs(mf[0, 1]) > 1e-13) or np.any(np.abs(mf[1, 0]) > 1e-13):
        raise ValueError("mean-field Hloc cannot have spin mixing in normal mode")

    ediag = bath_levels(bath)       # (Nspin, Norb|1, Nbath)
    vhyb = bath_hyb(bath)           # (Nspin, Norb, Nbath)
    hbath = bath.hbath() if bath.is_replica else None

    # ---- one-spin hopping matrices -----------------------------------
    def spin_hops(s_idx: int, h_imp: np.ndarray) -> List[Tuple[int, int, float]]:
        terms = []
        for i in range(norb):
            for j in range(norb):
                if i != j and h_imp[i, j] != 0.0:
                    terms.append((i, j, h_imp[i, j]))
        if hbath is not None:
            for k in range(nbath):
                hb = np.real(hbath[k, s_idx, s_idx])
                for i in range(norb):
                    for j in range(norb):
                        if i != j and hb[i, j] != 0.0:
                            terms.append((bath_level(cfg.bath_type, norb, nbath, i, k),
                                          bath_level(cfg.bath_type, norb, nbath, j, k),
                                          hb[i, j]))
        for i in range(norb):
            for k in range(nbath):
                vv = vhyb[s_idx, i, k]
                if vv != 0.0:
                    lb = bath_level(cfg.bath_type, norb, nbath, i, k)
                    terms.append((lb, i, vv))
                    terms.append((i, lb, vv))
        return terms

    exc = np.asarray(cfg.exc_field)
    hup = _hop_matrix(ups, ns, spin_hops(0, h_up_imp), du)
    hdw = _hop_matrix(dws, ns, spin_hops(isdw, h_dw_imp), dd)
    if np.any(exc != 0.0):
        up_t = [(i, j, exc[0] + exc[3]) for i in range(norb) for j in range(norb) if i != j]
        dw_t = [(i, j, exc[0] - exc[3]) for i in range(norb) for j in range(norb) if i != j]
        hup += _hop_matrix(ups, ns, up_t, du)
        hdw += _hop_matrix(dws, ns, dw_t, dd)

    # ---- diagonal ----------------------------------------------------
    occ_up = occupations(ups, ns).astype(np.float64)   # (du, ns)
    occ_dw = occupations(dws, ns).astype(np.float64)
    sfz = np.asarray(cfg.spin_field_z[:norb])

    e_up = np.zeros(ns)
    e_dw = np.zeros(ns)
    e_up[:norb] = np.diag(h_up_imp) - cfg.xmu + sfz
    e_dw[:norb] = np.diag(h_dw_imp) - cfg.xmu - sfz
    n_slots = ediag.shape[1]
    for i in range(n_slots):
        for k in range(nbath):
            lb = bath_level(cfg.bath_type, norb, nbath, i, k)
            e_up[lb] += ediag[0, i, k]
            e_dw[lb] += ediag[isdw, i, k]
    # Hartree shifts (reference H_local.f90 hfmode block)
    ustp_nd = um.ustp - np.diag(np.diag(um.ustp))
    ust_nd = um.ust - np.diag(np.diag(um.ust))
    const = 0.0
    if cfg.hfmode:
        shift = -0.5 * um.uloc - 0.5 * (ust_nd.sum(1) + ustp_nd.sum(1))
        e_up[:norb] += shift
        e_dw[:norb] += shift
        const += 0.25 * um.uloc.sum()
        const += 0.25 * (ust_nd.sum() + ustp_nd.sum())  # 0.5 per unordered pair

    d_up = occ_up @ e_up
    d_dw = occ_dw @ e_dw
    o_up = occ_up[:, :norb]
    o_dw = occ_dw[:, :norb]
    # intra-spin pair terms (parallel spins): 0.5 Σ_ab ustp_ab n_a n_b
    d_up += 0.5 * np.einsum("ia,ab,ib->i", o_up, ustp_nd, o_up)
    d_dw += 0.5 * np.einsum("ia,ab,ib->i", o_dw, ustp_nd, o_dw)
    # cross-spin density-density: Σ_ab (δ_ab uloc_a + ust_ab) ndw_b nup_a
    mx = np.diag(um.uloc) + ust_nd
    d = d_dw[:, None] + d_up[None, :] + const + o_dw @ mx @ o_up.T

    # ---- non-local Kronecker factors ---------------------------------
    nl_a: List[np.ndarray] = []
    nl_b: List[np.ndarray] = []
    if norb > 1 and np.any(um.jx != 0):
        # S-E: Jx[a,b] [c^+_a c_b]_up ⊗ [c^+_b c_a]_dw  (H_non_local.f90)
        for a in range(norb):
            for b in range(norb):
                if a != b and um.jx[a, b] != 0.0:
                    nl_a.append(_hop_perm(ups, ns, a, b, um.jx[a, b]))
                    nl_b.append(_hop_perm(dws, ns, b, a, 1.0))
    if norb > 1 and np.any(um.jp != 0):
        # P-H: Jp[a,b] [c^+_a c_b]_up ⊗ [c^+_a c_b]_dw
        for a in range(norb):
            for b in range(norb):
                if a != b and um.jp[a, b] != 0.0:
                    nl_a.append(_hop_perm(ups, ns, a, b, um.jp[a, b]))
                    nl_b.append(_hop_perm(dws, ns, a, b, 1.0))
    for t in um.sundry:
        # split the op string per spin, preserving per-spin application order
        # (per-spin Jordan-Wigner convention, reference H_sundry.f90)
        if t.delta_nup() != 0 or t.delta_ndw() != 0:
            raise ValueError("normal mode forbids spin-count-changing operators")
        up_ops = [(k, o) for (k, o, s) in t.ops if s == SPIN_UP]
        dw_ops = [(k, o) for (k, o, s) in t.ops if s == SPIN_DW]
        coeff = np.real(t.coeff)
        nl_a.append(_string_perm(ups, ns, up_ops, coeff))
        nl_b.append(_string_perm(dws, ns, dw_ops, 1.0))

    nl_perm = None
    if nl_a:
        nl_perm = (np.stack([s for s, _ in nl_a]),
                   np.stack([g for _, g in nl_a]),
                   np.stack([s for s, _ in nl_b]),
                   np.stack([g for _, g in nl_b]))
    op = NormalSectorOp(sector=sec, d=d, hup=hup, hdw=hdw, nl_perm=nl_perm)

    # ---- phonons ------------------------------------------------------
    if cfg.nph > 0:
        g = g_ph_matrix(cfg)
        op.ph_mat, op.ph_x = _phonon_matrices(cfg)
        gdiag = np.diag(g)
        op.eph_d = (o_dw @ gdiag)[:, None] + (o_up @ gdiag)[None, :]
        up_t = [(i, j, g[i, j]) for i in range(norb) for j in range(norb) if i != j]
        op.eph_up = _hop_matrix(ups, ns, up_t, du)
        op.eph_dw = _hop_matrix(dws, ns, up_t, dd)
    return op
