"""Blocked-Kronecker joint-sector operator: the superc/nonsu2 Hamiltonian
as per-block Kronecker factors.

The reference (and the ELL path here, models/joint.py) treats an Sz / Ntot
sector as one flat sorted Fock basis and multiplies with a row-wise sparse
gather — fundamentally random-access.  But every joint sector DECOMPOSES into (Nup, Ndw) product
blocks: within a block the basis is ups x dws exactly like the normal mode,
so

* every particle-number-conserving same-spin term (Hloc hopping,
  hybridization, bath hops — the bulk of the nonzeros) is a per-block
  Kronecker factor: dense (dup x dup) / (ddw x ddw) matmuls;
* pairing terms (superc: c†↑c†↓, Δ-bath) and spin-flip terms (nonsu2: SOC,
  in-plane fields, u-hybridization) CONNECT neighbouring blocks as
  per-spin signed partial permutations — vectorized axis gathers, with the
  cross-register Jordan-Wigner string reducing to the per-block scalar
  (-1)^{Nup} (Nup is constant within a block);
* mixed four-operator strings (Jx/Jp, nonsu2 sundry) split per register the
  same way.

The operator's vector layout is the concatenation of per-block
(dim_ph, ddw, dup) tensors ("blocked layout"); ``to_internal_flat`` /
``from_internal_flat`` convert to/from the sorted joint basis by one fixed
permutation (the Lanczos/GF drivers support internal-layout operators
via these hooks).

Parity target: the dense matrix of this operator under the sorted
permutation equals models/joint.build_joint_sector_op().to_dense() exactly
(tests/test_joint_kron.py battery).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EDConfig
from ..fock import apply_c, apply_cdg, enumerate_states, occupations, \
    state_index
from ..sectors import Sector


@dataclass
class _Block:
    nup: int
    ndw: int
    ups: np.ndarray       # sorted up-register basis (C(ns,nup) ints)
    dws: np.ndarray       # sorted dw-register basis
    offset: int           # start of this block in the blocked flat layout

    @property
    def dup(self) -> int:
        return len(self.ups)

    @property
    def ddw(self) -> int:
        return len(self.dws)

    @property
    def size(self) -> int:
        return self.dup * self.ddw


@dataclass
class _GatherTerm:
    """out[dst] += coeff * (dw_sgn ⊙ v[src][dw_src][:, up_src] ⊙ up_sgn)."""
    src: int
    dst: int
    coeff: complex
    up_src: np.ndarray    # (dup_dst,) int32 source column per target column
    up_sgn: np.ndarray    # (dup_dst,) float (0 invalidates)
    dw_src: np.ndarray    # (ddw_dst,) int32
    dw_sgn: np.ndarray


def _register_map(basis_src: np.ndarray, basis_dst: np.ndarray,
                  ops: List[Tuple[str, int]]):
    """Compose single-register operator substring; returns target-indexed
    (src_idx, sign) arrays over basis_dst (0/0 where no source)."""
    st = np.asarray(basis_src, np.int64)
    sign = np.ones(len(st))
    valid = np.ones(len(st), dtype=bool)
    for kind, lvl in ops:
        fn = apply_c if kind == "c" else apply_cdg
        st, s, v = fn(st, lvl)
        sign = sign * s
        valid &= v
    tgt = state_index(np.asarray(basis_dst, np.int64), st[valid])
    srcs = np.nonzero(valid)[0]
    good = tgt >= 0
    src_of = np.zeros(len(basis_dst), np.int32)
    sgn_of = np.zeros(len(basis_dst))
    src_of[tgt[good]] = srcs[good]
    sgn_of[tgt[good]] = sign[valid][good]
    return src_of, sgn_of


class BlockedTermAccumulator:
    """JointTermAccumulator-compatible accumulator building the blocked-Kron
    structure instead of sorted COO.  Basis ORDER: blocks in (nup
    descending-sz-scan) enumeration order; within a block, index =
    idw * dup + iup (up fastest)."""

    def __init__(self, sec: Sector, ns: int):
        self.ns = ns
        cfgmode = sec.mode
        blocks: List[_Block] = []
        off = 0
        pairs = []
        if cfgmode == "superc":
            sz = sec.qn[1]
            for nup in range(max(0, sz), min(ns, ns + sz) + 1):
                ndw = nup - sz
                if 0 <= ndw <= ns:
                    pairs.append((nup, ndw))
        else:  # nonsu2 (nt / ntj)
            n = sec.qn[1]
            for nup in range(max(0, n - ns), min(ns, n) + 1):
                pairs.append((nup, n - nup))
        for nup, ndw in pairs:
            b = _Block(nup, ndw, enumerate_states(ns, nup),
                       enumerate_states(ns, ndw), off)
            blocks.append(b)
            off += b.size
        self.blocks = blocks
        self.dim = off
        self._bidx: Dict[Tuple[int, int], int] = {
            (b.nup, b.ndw): i for i, b in enumerate(blocks)}
        # blocked-order joint states (for occ/diag and the sorted perm)
        parts = [
            (b.ups[None, :] | (b.dws[:, None] << np.int64(ns))).ravel()
            for b in blocks]
        self.states = (np.concatenate(parts) if parts
                       else np.zeros(0, np.int64))
        self.occ = occupations(self.states, 2 * ns).astype(np.float64)
        self.diag = np.zeros(self.dim)
        self.eph_diag = None
        # dense within-block same-spin factors (built lazily)
        self.hup = [np.zeros((b.dup, b.dup), complex) for b in blocks]
        self.hdw = [np.zeros((b.ddw, b.ddw), complex) for b in blocks]
        self.gathers: List[_GatherTerm] = []

    # -- JointTermAccumulator interface ---------------------------------
    def pos(self, level: int, spin: int) -> int:
        return level + spin * self.ns

    def add_diag(self, d: np.ndarray) -> None:
        self.diag += np.real(d)

    def add_opstring(self, ops: List[Tuple[str, int, int]],
                     coeff: complex) -> None:
        if coeff == 0:
            return
        # split per register, tracking the cross-register JW bookkeeping:
        # a dw operator's global string covers ALL up bits, i.e. a factor
        # (-1)^{nup at application time} = (-1)^{nup_block + dnup_so_far}
        up_ops: List[Tuple[str, int]] = []
        dw_ops: List[Tuple[str, int]] = []
        dnup = 0
        n_dw_ops = 0
        cross_fixed = 0          # sum of dnup values at each dw op
        for kind, lvl, spin in ops:
            if spin == 0:
                up_ops.append((kind, lvl))
                dnup += 1 if kind == "cdg" else -1
            else:
                dw_ops.append((kind, lvl))
                cross_fixed += dnup
        ddw_n = sum(1 if k == "cdg" else -1 for k, _ in dw_ops)
        n_dw_ops = len(dw_ops)

        for i, b in enumerate(self.blocks):
            nup_t = b.nup + dnup
            ndw_t = b.ndw + ddw_n
            j = self._bidx.get((nup_t, ndw_t))
            if j is None:
                continue
            tgt = self.blocks[j]
            up_src, up_sgn = _register_map(b.ups, tgt.ups, up_ops)
            dw_src, dw_sgn = _register_map(b.dws, tgt.dws, dw_ops)
            if not up_sgn.any() or not dw_sgn.any():
                continue
            cross = (-1.0) ** ((n_dw_ops * b.nup + cross_fixed) % 2)
            c = coeff * cross
            # same-spin within-block single-register maps merge into the
            # dense Kron factors (the matmul path)
            if not dw_ops and i == j:
                m = np.zeros((tgt.dup, b.dup), complex)
                cols = up_src[up_sgn != 0]
                rows = np.nonzero(up_sgn != 0)[0]
                m[rows, cols] = c * up_sgn[up_sgn != 0]
                self.hup[i] += m
                continue
            if not up_ops and i == j:
                m = np.zeros((tgt.ddw, b.ddw), complex)
                cols = dw_src[dw_sgn != 0]
                rows = np.nonzero(dw_sgn != 0)[0]
                m[rows, cols] = c * dw_sgn[dw_sgn != 0]
                self.hdw[i] += m
                continue
            self.gathers.append(_GatherTerm(
                src=i, dst=j, coeff=c,
                up_src=up_src.astype(np.int32), up_sgn=up_sgn,
                dw_src=dw_src.astype(np.int32), dw_sgn=dw_sgn))


class JointKronMatvec:
    """Device matvec over the blocked layout (solver-facing).

    ``__call__(v)`` takes/returns the flat blocked vector (dim_ph * dim_el);
    use to_internal_flat / from_internal_flat at the sorted-basis boundary.
    """

    def __init__(self, cfg: EDConfig, sec: Sector, acc: BlockedTermAccumulator,
                 eph_acc: Optional[BlockedTermAccumulator] = None,
                 dtype=jnp.complex128, mesh=None):
        from .normal import _phonon_matrices
        from ..ops.matvec import device_put_cplx
        self.sector = sec
        self.blocks = acc.blocks
        self.dim_el = acc.dim
        self.dim_ph = sec.dim_ph
        self.dtype = dtype
        self.mesh = mesh
        ndev = 1 if mesh is None else int(mesh.shape["dw"])
        self._ndw = ndev

        # padded per-block shapes: the dw axis of every block is padded to a
        # mesh multiple so it can carry a NamedSharding over the 'dw' axis —
        # the sharded form of the reference's superc/nonsu2 row split
        # (ED_SUPERC/ED_HAMILTONIAN_SUPERC_STORED_HxV.f90:366-432); the
        # cross-block gathers read the source block through GSPMD-inserted
        # all-gathers (the MPI_Allgatherv equivalent)
        self._shapes = [(-(-b.ddw // ndev) * ndev, b.dup)
                        for b in self.blocks]
        offs = np.cumsum([0] + [s[0] * s[1] for s in self._shapes])
        self._offsets = [int(o) for o in offs[:-1]]
        self.dim_el_pad = int(offs[-1])
        self.dim = self.dim_el_pad * self.dim_ph

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            row_sh = NamedSharding(mesh, P("dw", None))
            rep = NamedSharding(mesh, P())
            self._vsh = NamedSharding(mesh, P(None, "dw", None))
        else:
            row_sh = rep = self._vsh = None

        def put(x, sh=None):
            a = device_put_cplx(np.asarray(x), dtype)
            return a if sh is None else jax.device_put(a, sh)
        # static real-dtype mapping (no eager device op to find it)
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        def putr(x, sh=None):
            a = jax.device_put(jnp.asarray(np.asarray(x, np.dtype(rdt))))
            return a if sh is None else jax.device_put(a, sh)

        def pad_rows(a, rows):
            if a.shape[0] == rows:
                return np.asarray(a)
            out = np.zeros((rows,) + a.shape[1:], a.dtype)
            out[:a.shape[0]] = a
            return out

        # per-block diagonal (real) + dense spin factors (skip zero ones)
        self.diag_b = []
        for b, sh in zip(self.blocks, self._shapes):
            d = acc.diag[b.offset:b.offset + b.size].reshape(b.ddw, b.dup)
            self.diag_b.append(putr(pad_rows(d, sh[0]), row_sh))
        self.hup_b = [put(h.T, rep) if np.any(h) else None for h in acc.hup]
        self.hdw_b = [put(pad_rows(pad_rows(h, s[0]).T, s[0]).T, rep)
                      if np.any(h) else None
                      for h, s in zip(acc.hdw, self._shapes)]

        def group_gathers(gs):
            """Batch all gather terms sharing (src, dst) into ONE stacked
            take + weighted reduction: the per-term loop launched ~4 HLO
            ops per term (hundreds of kernel launches per matvec — the
            r04 joint-throughput bottleneck); a group costs 3 ops total.
            The per-term weight w[k,d,u] = coeff_k * dw_sgn_k[d] *
            up_sgn_k[u] is precomputed host-side.  Returns
            (device_groups, host_groups) — host copies feed the DS lo /
            exact-f64 weight splits in MixedJointKron."""
            groups: Dict[Tuple[int, int], list] = {}
            for g in gs:
                groups.setdefault((g.src, g.dst), []).append(g)
            # split large groups into even chunks of <= GATHER_CHUNK terms:
            # bounds the k-sized gather intermediate each chunk
            # materializes (not re-tuned on the GPU)
            GATHER_CHUNK = 6
            split: List[Tuple[Tuple[int, int], list]] = []
            for key, lst in sorted(groups.items()):
                nch = max(1, -(-len(lst) // GATHER_CHUNK))
                bounds = np.linspace(0, len(lst), nch + 1).astype(int)
                for lo, hi in zip(bounds[:-1], bounds[1:]):
                    if hi > lo:
                        split.append((key, lst[lo:hi]))
            dev_out, host_out = [], []
            for (src, dst), lst in split:
                ddw_p = self._shapes[dst][0]
                dup_d = self.blocks[dst].dup
                k = len(lst)
                dw_idx = np.zeros((k, ddw_p), np.int32)
                up_idx = np.zeros((k, dup_d), np.int32)
                # FACTORIZED weights: the per-term coeff (the only inexact
                # scalar) folds into the complex dw factor; the up factor
                # stays an exact ±1/0 sign — a dense (k, ddw, dup) weight
                # tensor would cost k x block-size HBM residency per group
                wdw = np.zeros((k, ddw_p), complex)
                usgn = np.zeros((k, dup_d))
                for j, g in enumerate(lst):
                    dw_idx[j, :len(g.dw_src)] = g.dw_src
                    up_idx[j] = g.up_src
                    wdw[j, :len(g.dw_sgn)] = g.coeff * g.dw_sgn
                    usgn[j] = g.up_sgn
                host_out.append((src, dst, dw_idx, up_idx, wdw, usgn))
                dev_out.append((src, dst,
                                jax.device_put(jnp.asarray(dw_idx)),
                                jax.device_put(jnp.asarray(up_idx)),
                                put(wdw, rep), putr(usgn, rep)))
            return dev_out, host_out

        self.gathers, self._gathers_host = group_gathers(acc.gathers)

        self.has_ph = cfg.nph > 0
        if self.has_ph:
            ph_mat, ph_x = _phonon_matrices(cfg)
            self.ph_mat = putr(np.real(ph_mat))
            self.ph_x = putr(np.real(ph_x))
            self.eph_diag_b = [
                putr(pad_rows(acc.eph_diag[b.offset:b.offset + b.size]
                              .reshape(b.ddw, b.dup), sh[0]), row_sh)
                for b, sh in zip(self.blocks, self._shapes)]
            self.eph_up_b = [put(h.T, rep) if np.any(h) else None
                             for h in eph_acc.hup]
            self.eph_dw_b = [put(pad_rows(pad_rows(h, s[0]).T, s[0]).T, rep)
                             if np.any(h) else None
                             for h, s in zip(eph_acc.hdw, self._shapes)]
            self.eph_gathers, self._eph_gathers_host = \
                group_gathers(eph_acc.gathers)

        # sorted -> padded-blocked position map: sorted index k lives at
        # padded position scatter_idx[k] (per phonon plane)
        order = np.argsort(acc.states, kind="stable")
        pad_pos = np.zeros(self.dim_el, np.int64)
        for b, off in zip(self.blocks, self._offsets):
            # only the dw axis is padded (appended rows), so unpadded
            # in-block offsets carry over unchanged
            pad_pos[b.offset:b.offset + b.size] = \
                off + np.arange(b.size, dtype=np.int64)
        self._scatter_idx = jax.device_put(
            jnp.asarray(pad_pos[order].astype(np.int32)))
        mask = np.zeros(self.dim_el_pad, np.float32)
        mask[pad_pos] = 1.0
        self._mask = jax.device_put(jnp.asarray(mask))
        nnz = int(np.sum(np.abs(acc.diag) > 0))
        for b, h in zip(self.blocks, acc.hup):
            nnz += int(np.count_nonzero(h)) * b.ddw
        for b, h in zip(self.blocks, acc.hdw):
            nnz += int(np.count_nonzero(h)) * b.dup
        nnz += sum(int(np.count_nonzero(g.up_sgn)) *
                   int(np.count_nonzero(g.dw_sgn)) for g in acc.gathers)
        self.nnz = max(nnz, acc.dim) * max(1, self.dim_ph)

    # -- layout conversion ----------------------------------------------
    def to_internal_flat(self, v_sorted):
        """sorted-basis vector -> padded blocked layout (scatter)."""
        v2 = v_sorted.reshape(self.dim_ph, self.dim_el)
        out = jnp.zeros((self.dim_ph, self.dim_el_pad), self.dtype)
        return out.at[:, self._scatter_idx].set(v2.astype(self.dtype)) \
            .reshape(-1)

    def from_internal_flat(self, v_blocked):
        v2 = v_blocked.reshape(self.dim_ph, self.dim_el_pad)
        return jnp.take(v2, self._scatter_idx, axis=1).reshape(-1)

    def v0_project(self, v):
        """Zero the structural dw padding of random start vectors."""
        v2 = v.reshape(self.dim_ph, self.dim_el_pad)
        return (v2 * self._mask[None, :].astype(v.dtype)).reshape(-1)

    # -- matvec ----------------------------------------------------------
    def _apply_el(self, vb: List, hup_b, hdw_b, diag_b, gathers,
                  precision=None):
        """One electronic application on the per-block tensor list."""
        out = []
        for i, v in enumerate(vb):
            w = diag_b[i] * v if diag_b is not None else jnp.zeros_like(v)
            if hup_b[i] is not None:
                w = w + jnp.einsum("pdu,uv->pdv", v, hup_b[i],
                                   preferred_element_type=v.dtype,
                                   precision=precision)
            if hdw_b[i] is not None:
                w = w + jnp.einsum("de,peu->pdu", hdw_b[i], v,
                                   preferred_element_type=v.dtype,
                                   precision=precision)
            out.append(w)
        for (src, dst, dw_idx, up_idx, wdw, usgn) in gathers:
            t2 = self._gather_take(vb[src], dw_idx, up_idx)
            out[dst] = out[dst] + self._gather_reduce(
                t2, wdw, usgn, precision=precision)
        return out

    @staticmethod
    def _gather_take(v, dw_idx, up_idx):
        """Stacked signed-gather source: t2[p,k,d,u] =
        v[p, dw_idx[k,d], up_idx[k,u]] for a whole (src,dst) term group —
        one plain take plus one vmapped (small-index) take."""
        t = jnp.take(v, dw_idx, axis=1)           # (ph, k, ddw_p, dup_src)
        return jax.vmap(lambda tk, ik: jnp.take(tk, ik, axis=-1),
                        in_axes=(1, 0), out_axes=1)(t, up_idx)

    @staticmethod
    def _gather_reduce(t2, wdw, usgn, precision=None):
        """out[p,d,u] = Σ_k wdw[k,d] * usgn[k,u] * t2[p,k,d,u].

        Elementwise multiply chain + sum: XLA fuses it into one loop
        fusion over t2, and elementwise products carry no matmul
        precision setting — no precision knob needed (the ``precision`` arg is accepted for
        call-site compatibility)."""
        w3 = (wdw[None, :, :, None].astype(t2.dtype)
              * usgn[None, :, None, :].astype(t2.dtype))
        return (t2 * w3).sum(axis=1)

    def split_blocks(self, v):
        v2 = v.reshape(self.dim_ph, self.dim_el_pad)
        vb = [v2[:, o:o + s[0] * s[1]].reshape(self.dim_ph, *s)
              for o, s in zip(self._offsets, self._shapes)]
        if self._vsh is not None:
            vb = [jax.lax.with_sharding_constraint(b, self._vsh) for b in vb]
        return vb

    def join_blocks(self, vb):
        if self._vsh is not None:
            vb = [jax.lax.with_sharding_constraint(b, self._vsh) for b in vb]
        return jnp.concatenate(
            [w.reshape(self.dim_ph, -1) for w in vb], axis=1).reshape(-1)

    def __call__(self, v):
        vb = [b.astype(self.dtype) for b in self.split_blocks(v)]
        out = self._apply_el(vb, self.hup_b, self.hdw_b, self.diag_b,
                             self.gathers)
        if self.has_ph:
            # phonon oscillator + e-ph: X ⊗ (eph_diag + eph hops)
            ev = self._apply_el(vb, self.eph_up_b, self.eph_dw_b,
                                self.eph_diag_b, self.eph_gathers)
            for i in range(len(out)):
                out[i] = out[i] \
                    + jnp.einsum("pq,qdu->pdu", self.ph_mat.astype(self.dtype),
                                 vb[i]) \
                    + jnp.einsum("pq,qdu->pdu", self.ph_x.astype(self.dtype),
                                 ev[i])
        return self.join_blocks(out).astype(v.dtype)

    def to_dense(self) -> np.ndarray:
        """Dense matrix in the BLOCKED layout (tests)."""
        eye = np.eye(self.dim, dtype=complex)
        cols = [np.asarray(self(jnp.asarray(eye[:, i], self.dtype)))
                for i in range(self.dim)]
        return np.stack(cols, axis=1)


def _gather_ri(Xv, Yv, dw_idx, up_idx, w_re, w_im, usgn):
    """f64 real/imag split of one stacked gather group on the real
    embedding: returns (Re, Im) contributions for the factorized complex
    weight (w_re + i*w_im)[k,d] * usgn[k,u] applied to Xv + i*Yv."""
    f64 = jnp.float64
    take = JointKronMatvec._gather_take
    tX = take(Xv, dw_idx, up_idx) * usgn[None, :, None, :]
    tY = take(Yv, dw_idx, up_idx) * usgn[None, :, None, :]

    def red(t, w):
        return jnp.einsum("pkdu,kd->pdu", t, w,
                          preferred_element_type=f64)

    ax = ay = 0.0
    if w_re is not None:
        ax = red(tX, w_re)
        ay = red(tY, w_re)
    if w_im is not None:
        ax = ax - red(tY, w_im)
        ay = ay + red(tX, w_im)
    return ax, ay


class _RealExactJoint:
    """f64-exact application of the complex blocked-Kron H on the REAL
    embedding: H(x+iy) = (Ax − By) + i(Bx + Ay) with A = Re H, B = Im H,
    as doubled real einsums, so the real-embedded DS solver never forms a
    c128 operand.  Used only for the Rayleigh-Ritz polish — a handful of calls/solve."""

    def __init__(self, op: "MixedJointKron"):
        self.op = op
        self.dim = op.dim
        self.dtype = jnp.float64

    def v0_project(self, v):
        return self.op.v0_project(v)

    def jmap(self, v):
        return self.op.jmap(v)

    # layout boundary: the exact operator lives in the SAME real-embedded
    # padded layout as the owning MixedJointKron, so GF/Krylov drivers that
    # receive it directly (ed_mixed_gf=False) convert through the parent
    def to_internal_flat(self, v_sorted):
        return self.op.to_internal_flat(v_sorted)

    def from_internal_flat(self, v_real):
        return self.op.from_internal_flat(v_real)

    def __call__(self, v):
        op = self.op
        v = v.astype(jnp.float64)
        v2 = v.reshape(2, op.dim_ph, op.dim_el_pad)

        def split(u):
            return [u[:, o:o + s[0] * s[1]].reshape(op.dim_ph, *s)
                    for o, s in zip(op._offsets, op._shapes)]

        X, Y = split(v2[0]), split(v2[1])
        ox = [op.diag64[i] * X[i] for i in range(len(X))]
        oy = [op.diag64[i] * Y[i] for i in range(len(Y))]
        f64 = jnp.float64
        from ..ops.matvec import ExactKronMatvec as _EK
        for i in range(len(X)):
            # factors applied in sparse-ELL form (gather + f64 elementwise
            # FMA), as in ops.matvec.ExactKronMatvec
            if op.hup_ell[i] is not None:
                re_e, im_e = op.hup_ell[i]
                if re_e is not None:
                    ox[i] = ox[i] + _EK._up(X[i], re_e)
                    oy[i] = oy[i] + _EK._up(Y[i], re_e)
                if im_e is not None:
                    ox[i] = ox[i] - _EK._up(Y[i], im_e)
                    oy[i] = oy[i] + _EK._up(X[i], im_e)
            if op.hdw_ell[i] is not None:
                re_e, im_e = op.hdw_ell[i]
                if re_e is not None:
                    ox[i] = ox[i] + _EK._dw(X[i], re_e)
                    oy[i] = oy[i] + _EK._dw(Y[i], re_e)
                if im_e is not None:
                    ox[i] = ox[i] - _EK._dw(Y[i], im_e)
                    oy[i] = oy[i] + _EK._dw(X[i], im_e)
        for (src, dst, dw_idx, up_idx, (w_re, w_im, usgn)) in op.gathers_ri:
            ax, ay = _gather_ri(X[src], Y[src], dw_idx, up_idx, w_re, w_im,
                                usgn)
            ox[dst] = ox[dst] + ax
            oy[dst] = oy[dst] + ay
        if op.has_ph:
            # phonon oscillator (real) + e-ph: TRUE f64 operand copies
            # (ph_mat64/ph_x64/eph_diag64/eph_*_ri, stored by
            # MixedJointKron.__init__) — the parent's f32/c64 operands would
            # floor the exact path at ~1e-7 operand rounding
            exb = [op.eph_diag64[i] * X[i] for i in range(len(X))]
            eyb = [op.eph_diag64[i] * Y[i] for i in range(len(Y))]
            for i in range(len(X)):
                if op.eph_up_ell[i] is not None:
                    re_e, im_e = op.eph_up_ell[i]
                    if re_e is not None:
                        exb[i] = exb[i] + _EK._up(X[i], re_e)
                        eyb[i] = eyb[i] + _EK._up(Y[i], re_e)
                    if im_e is not None:
                        exb[i] = exb[i] - _EK._up(Y[i], im_e)
                        eyb[i] = eyb[i] + _EK._up(X[i], im_e)
                if op.eph_dw_ell[i] is not None:
                    re_e, im_e = op.eph_dw_ell[i]
                    if re_e is not None:
                        exb[i] = exb[i] + _EK._dw(X[i], re_e)
                        eyb[i] = eyb[i] + _EK._dw(Y[i], re_e)
                    if im_e is not None:
                        exb[i] = exb[i] - _EK._dw(Y[i], im_e)
                        eyb[i] = eyb[i] + _EK._dw(X[i], im_e)
            for (src, dst, dw_idx, up_idx, (w_re, w_im, usgn)) \
                    in op.eph_gathers_ri:
                ax, ay = _gather_ri(X[src], Y[src], dw_idx, up_idx,
                                    w_re, w_im, usgn)
                exb[dst] = exb[dst] + ax
                eyb[dst] = eyb[dst] + ay
            def phap(m, t):
                rows = []
                for p in range(m.shape[0]):
                    acc = None
                    for q in range(m.shape[1]):
                        if m[p, q] == 0.0:
                            continue
                        term = m[p, q] * t[q]
                        acc = term if acc is None else acc + term
                    rows.append(acc if acc is not None
                                else jnp.zeros_like(t[0]))
                return jnp.stack(rows)
            for i in range(len(X)):
                ox[i] = ox[i] + phap(op.ph_mat_h, X[i]) \
                    + phap(op.ph_x_h, exb[i])
                oy[i] = oy[i] + phap(op.ph_mat_h, Y[i]) \
                    + phap(op.ph_x_h, eyb[i])
        flat_x = jnp.concatenate([w.reshape(op.dim_ph, -1) for w in ox],
                                 axis=1).reshape(-1)
        flat_y = jnp.concatenate([w.reshape(op.dim_ph, -1) for w in oy],
                                 axis=1).reshape(-1)
        return jnp.concatenate([flat_x, flat_y])


class MixedJointKron(JointKronMatvec):
    """Blocked-Kron joint matvec in double-single complex64 with a
    REAL-EMBEDDED solver interface.

    The pair works in c64 planes and never forms a c128 operand, so the
    joint solver's vectors live in the real embedding of the complex sector space:
    a complex vector ψ becomes the real stack [Re ψ; Im ψ] and the
    Hermitian H becomes the real-symmetric operator
    [[Re H, −Im H], [Im H, Re H]].  Lanczos on the embedding has the same
    spectral measure per start vector; each complex eigenvector appears as
    a 2-dimensional real eigenspace {v, J v} with J = multiply-by-i
    (:meth:`jmap`), which the eigensolver deflates as one state.

    * ``pair(v_real32)`` — the DS fast path: form c64 from the stacked
      halves, apply H = Hhi (HIGHEST precision) + Hlo (DEFAULT), restack.
    * ``exact(v_real64)`` — f64-exact application via doubled REAL
      einsums (4 real matmuls per complex factor; used only by the
      Rayleigh-Ritz polish).
    """

    def __init__(self, cfg: EDConfig, sec: Sector, acc: BlockedTermAccumulator,
                 eph_acc: Optional[BlockedTermAccumulator] = None, mesh=None):
        super().__init__(cfg, sec, acc, eph_acc=eph_acc, dtype=jnp.complex64,
                         mesh=mesh)
        self.dtype = jnp.float64
        self.dim_c = self.dim           # complex internal length
        self.dim = 2 * self.dim_c       # real-embedded solver length
        from ..ops.matvec import device_put_cplx
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(mesh, P())
        else:
            rep = None

        def put_lo(h):
            h = np.asarray(h, complex)
            lo = h - np.asarray(h.astype(np.complex64), complex)
            if not np.any(np.abs(lo) > 0):
                return None
            a = device_put_cplx(lo, jnp.complex64)
            return a if rep is None else jax.device_put(a, rep)

        def putr64(x):
            a = jax.device_put(jnp.asarray(np.asarray(x, np.float64)))
            return a if rep is None else jax.device_put(a, rep)

        self.hup_lo = [put_lo(h.T) if np.any(h) else None for h in acc.hup]
        self.hdw_lo = []
        for h, s in zip(acc.hdw, self._shapes):
            if not np.any(h):
                self.hdw_lo.append(None)
                continue
            hp = np.zeros((s[0], s[0]), complex)
            hp[:h.shape[0], :h.shape[1]] = h
            self.hdw_lo.append(put_lo(hp))
        # real diagonal: f32 hi + f32 lo planes
        self.diag_lo = []
        for b, s in zip(self.blocks, self._shapes):
            d = acc.diag[b.offset:b.offset + b.size].reshape(b.ddw, b.dup)
            dp = np.zeros(s)
            dp[:b.ddw] = d
            lo = (dp - dp.astype(np.float32)).astype(np.float32)
            a = jax.device_put(jnp.asarray(lo)) if np.any(lo) else None
            self.diag_lo.append(a)
        # gather dw-weight lo-planes: c64 rounding of the host f64 weights
        # (the up factor is an exact sign, no lo plane needed)
        def lo_of(host_groups):
            out = []
            for (_s, _d, _di, _ui, wdw, _us) in host_groups:
                lo = wdw - np.asarray(wdw.astype(np.complex64), complex)
                out.append(device_put_cplx(lo, jnp.complex64)
                           if np.any(np.abs(lo) > 0) else None)
            return out
        self.gather_lo = lo_of(self._gathers_host)

        # f64 real/imag dw-weight splits for the exact real-embedded path
        def ri_groups(host_groups):
            out = []
            for (src, dst, dw_idx, up_idx, wdw, usgn) in host_groups:
                w_re = putr64(wdw.real) if np.any(wdw.real) else None
                w_im = putr64(wdw.imag) if np.any(wdw.imag) else None
                out.append((src, dst,
                            jax.device_put(jnp.asarray(dw_idx)),
                            jax.device_put(jnp.asarray(up_idx)),
                            (w_re, w_im, putr64(usgn))))
            return out
        self.gathers_ri = ri_groups(self._gathers_host)
        self.eph_gathers_ri = ri_groups(self._eph_gathers_host) \
            if self.has_ph else []
        # sparse-ELL forms of the f64 factors: the exact path applies them
        # as gathers + f64 elementwise FMA (see ops.matvec.ExactKronMatvec)
        from ..ops.matvec import _ell_rows

        def ri_ell(h, pad_to=None):
            h = np.asarray(h, complex)
            if pad_to is not None:
                hpz = np.zeros((pad_to, pad_to), complex)
                hpz[:h.shape[0], :h.shape[1]] = h
                h = hpz
            re = _ell_rows(h.real) if np.any(h.real) else None
            im = _ell_rows(h.imag) if np.any(h.imag) else None
            return (re, im)
        self.hup_ell = [ri_ell(h) if np.any(h) else None for h in acc.hup]
        self.hdw_ell = [ri_ell(h, pad_to=s[0]) if np.any(h) else None
                        for h, s in zip(acc.hdw, self._shapes)]
        self.diag64 = []
        for b, s in zip(self.blocks, self._shapes):
            dp = np.zeros(s)
            dp[:b.ddw] = acc.diag[b.offset:b.offset + b.size] \
                .reshape(b.ddw, b.dup)
            self.diag64.append(putr64(dp))
        # f64 phonon/e-ph operand copies for the exact path: the c64-mode
        # parent stores ph_mat/ph_x/eph_diag at f32 and the e-ph factors at
        # c64, which would floor the 'exact' polish at ~1e-7 operand
        # rounding (mirrors the ELL factor forms / diag64 above)
        if self.has_ph:
            from .normal import _phonon_matrices
            ph_mat, ph_x = _phonon_matrices(cfg)
            self.ph_mat64 = putr64(np.real(ph_mat))
            self.ph_x64 = putr64(np.real(ph_x))
            self.ph_mat_h = np.real(np.asarray(ph_mat, complex))
            self.ph_x_h = np.real(np.asarray(ph_x, complex))
            self.eph_diag64 = []
            for b, s in zip(self.blocks, self._shapes):
                dp = np.zeros(s)
                dp[:b.ddw] = acc.eph_diag[b.offset:b.offset + b.size] \
                    .reshape(b.ddw, b.dup)
                self.eph_diag64.append(putr64(dp))
            self.eph_up_ell = [ri_ell(h) if np.any(h) else None
                               for h in eph_acc.hup]
            self.eph_dw_ell = [ri_ell(h, pad_to=s[0]) if np.any(h) else None
                               for h, s in zip(eph_acc.hdw, self._shapes)]
        else:
            self.ph_mat64 = self.ph_x64 = None
            self.eph_diag64 = self.eph_up_ell = self.eph_dw_ell = None
        self.exact = _RealExactJoint(self)

    def _pair_blocks(self, vb):
        """(main, corr) per-block lists from c64 block tensors."""
        hp = jax.lax.Precision.HIGHEST
        # gathers handled below so each group's takes run ONCE for both
        # the hi and lo weight planes
        main = self._apply_el(vb, self.hup_b, self.hdw_b, self.diag_b,
                              [], precision=hp)
        corr = []
        for i, v in enumerate(vb):
            w = (self.diag_lo[i] * v if self.diag_lo[i] is not None
                 else jnp.zeros_like(v))
            if self.hup_lo[i] is not None:
                w = w + jnp.einsum("pdu,uv->pdv", v, self.hup_lo[i],
                                   preferred_element_type=v.dtype)
            if self.hdw_lo[i] is not None:
                w = w + jnp.einsum("de,peu->pdu", self.hdw_lo[i], v,
                                   preferred_element_type=v.dtype)
            corr.append(w)
        for lo_w, (src, dst, dw_idx, up_idx, wdw, usgn) in zip(
                self.gather_lo, self.gathers):
            t2 = self._gather_take(vb[src], dw_idx, up_idx)
            main[dst] = main[dst] + self._gather_reduce(t2, wdw, usgn,
                                                        precision=hp)
            if lo_w is not None:
                corr[dst] = corr[dst] + self._gather_reduce(
                    t2, lo_w, usgn, precision=hp)
        if self.has_ph:
            ev = self._apply_el(vb, self.eph_up_b, self.eph_dw_b,
                                self.eph_diag_b, self.eph_gathers,
                                precision=hp)
            for i in range(len(main)):
                main[i] = main[i] \
                    + jnp.einsum("pq,qdu->pdu",
                                 self.ph_mat.astype(jnp.complex64), vb[i],
                                 precision=hp) \
                    + jnp.einsum("pq,qdu->pdu",
                                 self.ph_x.astype(jnp.complex64), ev[i],
                                 precision=hp)
        return main, corr

    # -- real-embedded solver interface ---------------------------------
    def _to_c64(self, v):
        v2 = v.reshape(2, self.dim_c)
        return (v2[0] + 1j * v2[1]).astype(jnp.complex64)

    @staticmethod
    def _restack(w):
        return jnp.concatenate([jnp.real(w), jnp.imag(w)])

    def pair(self, v):
        """real (2*dim_c,) f32 -> (main, corr) real f32 stacks."""
        vc = self._to_c64(v.astype(jnp.float32))
        vb = [b.astype(jnp.complex64) for b in self.split_blocks(vc)]
        main, corr = self._pair_blocks(vb)
        return (self._restack(self.join_blocks(main)).astype(jnp.float32),
                self._restack(self.join_blocks(corr)).astype(jnp.float32))

    def jmap(self, v):
        """The complex structure J (multiply by i) on the real embedding:
        (re, im) -> (-im, re).  Each converged eigenvector's J-partner
        spans the same complex state; the eigensolver deflates it."""
        v2 = v.reshape(2, self.dim_c)
        return jnp.concatenate([-v2[1], v2[0]])

    def __call__(self, v):
        # DS-accuracy application on the real embedding (the exact path is
        # self.exact); input-lo term dropped as in the normal-mode scheme
        main, corr = self.pair(v.astype(jnp.float32))
        return main.astype(jnp.float64) + corr.astype(jnp.float64)

    # layout conversion overrides: sorted COMPLEX vector <-> real stack
    def to_internal_flat(self, v_sorted):
        v2 = v_sorted.reshape(self.dim_ph, self.dim_el)
        re = jnp.zeros((self.dim_ph, self.dim_el_pad), jnp.float64) \
            .at[:, self._scatter_idx].set(jnp.real(v2).astype(jnp.float64))
        im = jnp.zeros((self.dim_ph, self.dim_el_pad), jnp.float64) \
            .at[:, self._scatter_idx].set(jnp.imag(v2).astype(jnp.float64))
        return jnp.concatenate([re.reshape(-1), im.reshape(-1)])

    def from_internal_flat(self, v_real):
        v2 = v_real.reshape(2, self.dim_ph, self.dim_el_pad)
        re = jnp.take(v2[0], self._scatter_idx, axis=1)
        im = jnp.take(v2[1], self._scatter_idx, axis=1)
        return ((re + 1j * im).astype(jnp.complex128)).reshape(-1)

    def v0_project(self, v):
        v2 = v.reshape(2, self.dim_ph, self.dim_el_pad)
        return (v2 * self._mask[None, None, :].astype(v.dtype)).reshape(-1)


# ---------------------------------------------------------------------------
# pytree registration: the operators can be passed AS JIT ARGUMENTS
# (operands become traced inputs rather than constants baked into each
# compiled program)
# ---------------------------------------------------------------------------


def _gather_arrays(gathers):
    return [tuple(g[2:]) for g in gathers]


def _jkm_dyn(op) -> dict:
    dyn = {
        "diag_b": op.diag_b, "hup_b": op.hup_b, "hdw_b": op.hdw_b,
        "g": _gather_arrays(op.gathers),
        "scatter": op._scatter_idx, "mask": op._mask,
    }
    if op.has_ph:
        dyn.update(ph_mat=op.ph_mat, ph_x=op.ph_x,
                   eph_diag_b=op.eph_diag_b, eph_up_b=op.eph_up_b,
                   eph_dw_b=op.eph_dw_b, eph_g=_gather_arrays(op.eph_gathers))
    return dyn


def _jkm_set(op, dyn) -> None:
    op.diag_b = list(dyn["diag_b"])
    op.hup_b = list(dyn["hup_b"])
    op.hdw_b = list(dyn["hdw_b"])
    op.gathers = [g[:2] + tuple(ga)
                  for g, ga in zip(op.gathers, dyn["g"])]
    op._scatter_idx = dyn["scatter"]
    op._mask = dyn["mask"]
    if op.has_ph:
        op.ph_mat = dyn["ph_mat"]
        op.ph_x = dyn["ph_x"]
        op.eph_diag_b = list(dyn["eph_diag_b"])
        op.eph_up_b = list(dyn["eph_up_b"])
        op.eph_dw_b = list(dyn["eph_dw_b"])
        op.eph_gathers = [g[:2] + tuple(ga)
                          for g, ga in zip(op.eph_gathers, dyn["eph_g"])]


def _jkm_flatten(op):
    return (_jkm_dyn(op),), op


def _jkm_unflatten(aux, children):
    import copy
    op = copy.copy(aux)
    _jkm_set(op, children[0])
    return op


def _mjk_flatten(op):
    dyn = _jkm_dyn(op)
    dyn.update(hup_lo=op.hup_lo, hdw_lo=op.hdw_lo, diag_lo=op.diag_lo,
               hup_ell=op.hup_ell, hdw_ell=op.hdw_ell, diag64=op.diag64,
               gather_lo=op.gather_lo,
               g_ri=[tuple(g[2:]) for g in op.gathers_ri],
               eph_g_ri=[tuple(g[2:]) for g in op.eph_gathers_ri])
    if op.has_ph:
        dyn.update(ph_mat64=op.ph_mat64, ph_x64=op.ph_x64,
                   eph_diag64=op.eph_diag64, eph_up_ell=op.eph_up_ell,
                   eph_dw_ell=op.eph_dw_ell)
    return (dyn,), op


def _mjk_unflatten(aux, children):
    import copy
    op = copy.copy(aux)
    dyn = children[0]
    _jkm_set(op, dyn)
    op.hup_lo = list(dyn["hup_lo"])
    op.hdw_lo = list(dyn["hdw_lo"])
    op.diag_lo = list(dyn["diag_lo"])
    op.hup_ell = list(dyn["hup_ell"])
    op.hdw_ell = list(dyn["hdw_ell"])
    op.diag64 = list(dyn["diag64"])
    op.gather_lo = list(dyn["gather_lo"])
    op.gathers_ri = [g[:2] + tuple(ga)
                     for g, ga in zip(op.gathers_ri, dyn["g_ri"])]
    op.eph_gathers_ri = [g[:2] + tuple(ga)
                         for g, ga in zip(op.eph_gathers_ri,
                                          dyn["eph_g_ri"])]
    if op.has_ph:
        op.ph_mat64 = dyn["ph_mat64"]
        op.ph_x64 = dyn["ph_x64"]
        op.eph_diag64 = list(dyn["eph_diag64"])
        op.eph_up_ell = list(dyn["eph_up_ell"])
        op.eph_dw_ell = list(dyn["eph_dw_ell"])
    op.exact = _RealExactJoint(op)
    return op


jax.tree_util.register_pytree_node(JointKronMatvec, _jkm_flatten,
                                   _jkm_unflatten)
jax.tree_util.register_pytree_node(MixedJointKron, _mjk_flatten,
                                   _mjk_unflatten)


def build_joint_kron_op(cfg: EDConfig, sec: Sector, hloc, um, bath,
                        hloc_anomalous=None,
                        dtype=jnp.complex128, mesh=None,
                        mixed: bool = False) -> JointKronMatvec:
    from .joint import _enumerate_joint_terms
    if sec.qn[0] not in ("sz", "nt"):
        raise ValueError("blocked-Kron operator requires full (Nup,Ndw) "
                         "product blocks; Jz-filtered sectors use the ELL "
                         "path")
    acc = BlockedTermAccumulator(sec, sec.ns)
    eph = _enumerate_joint_terms(cfg, sec, hloc, um, bath, hloc_anomalous,
                                 acc, lambda: BlockedTermAccumulator(
                                     sec, sec.ns))
    if mixed:
        # real-embedded DS operator; .exact (f64 real-split application) is
        # installed by __init__ — consumed by the Rayleigh-Ritz polish
        # (diag.py refine) and ed_mixed_gf=False
        return MixedJointKron(cfg, sec, acc, eph_acc=eph, mesh=mesh)
    return JointKronMatvec(cfg, sec, acc, eph_acc=eph, dtype=dtype, mesh=mesh)
