"""Device-side sector matvecs.

Two operator classes cover all three ED modes:

* :class:`KronMatvec` — normal mode. The sector vector is a dense tensor
  ``V[DimPh, DimDw, DimUp]``; H·V is dense matmuls on the spin-factor
  matrices, replacing the reference's row-loop CSR SpMV
  (ED_NORMAL/..._STORED_HxV.f90:765-1082).
* :class:`EllMatvec` — superc/nonsu2 joint sectors. Padded-ELL storage
  (fixed nnz/row) with gather + fused multiply-add; replaces the reference's
  row-split CSR + Allgatherv matvec (ED_SUPERC/..._STORED_HxV.f90:366-432).

Both expose ``__call__(v)`` on flat vectors and carry ``dim``/``dtype`` so the
eigensolvers are representation-agnostic.

Sharding: ``shard()`` places the dw axis of V (Kron) or rows (ELL) over a
mesh axis; the up/dw transpose the reference does with MPI_AlltoAllV
(ED_HAMILTONIAN_NORMAL_COMMON.f90:66-167) becomes an XLA collective inserted
by GSPMD when contracting the sharded axis.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.normal import NormalSectorOp


def device_put_cplx(x, dtype=jnp.complex128):
    """Host array -> device array of ``dtype`` (real or complex)."""
    return jax.device_put(np.asarray(x).astype(np.dtype(dtype)))


def _perm_factor(mats: np.ndarray):
    """Decompose a stack of ≤1-nnz-per-row matrices (signed partial
    permutations — every c/c† operator-string Kron factor has this form)
    into (src int32, sign) arrays; returns None if any row has >1 nnz."""
    k, nrow, _ = mats.shape
    src = np.zeros((k, nrow), dtype=np.int32)
    sgn = np.zeros((k, nrow), dtype=mats.dtype)
    for i in range(k):
        rows, cols = np.nonzero(mats[i])
        if len(np.unique(rows)) != len(rows):
            return None
        src[i, rows] = cols
        sgn[i, rows] = mats[i, rows, cols]
    return src, sgn


class KronMatvec:
    """H·V = D⊙V + V@Hupᵀ + Hdw@V + Σ_k B_k@V@A_kᵀ (+ phonon terms).

    The nonlocal factors A_k/B_k (spin-exchange, pair-hopping, sundry U_ijkl
    strings — reference stored/H_non_local.f90) are signed partial
    permutations, so their term is applied as two chained axis gathers plus a
    rank-1 sign mask instead of two dense matmuls — O(dim) HBM traffic
    instead of O(dim^1.5) MXU FLOPs."""

    def __init__(self, op: NormalSectorOp, dtype=jnp.float64,
                 sharding: Optional[jax.sharding.NamedSharding] = None):
        self.shape3 = (op.sector.dim_ph, op.hdw.shape[0], op.hup.shape[0])
        self.dim = int(np.prod(self.shape3))
        self.dtype = dtype
        put = lambda x: jax.device_put(jnp.asarray(x, dtype))
        ops = {"d": put(op.d), "hup_t": put(op.hup.T), "hdw": put(op.hdw)}
        if getattr(op, "nl_perm", None) is not None:
            src_a, sgn_a, src_b, sgn_b = op.nl_perm
            ops["nl_ua"] = jax.device_put(jnp.asarray(src_a))
            ops["nl_sa"] = put(sgn_a)
            ops["nl_eb"] = jax.device_put(jnp.asarray(src_b))
            ops["nl_sb"] = put(sgn_b)
        elif getattr(op, "nl_a", None) is not None:
            pa = _perm_factor(op.nl_a)
            pb = _perm_factor(op.nl_b)
            if pa is not None and pb is not None:
                ops["nl_ua"] = jax.device_put(jnp.asarray(pa[0]))
                ops["nl_sa"] = put(pa[1])
                ops["nl_eb"] = jax.device_put(jnp.asarray(pb[0]))
                ops["nl_sb"] = put(pb[1])
            else:
                ops["nl_a"] = put(np.swapaxes(op.nl_a, 1, 2))
                ops["nl_b"] = put(op.nl_b)
        if op.ph_mat is not None:
            ops["ph_mat"] = put(op.ph_mat)
            ops["ph_x"] = put(op.ph_x)
            ops["eph_d"] = put(op.eph_d)
            ops["eph_up_t"] = put(op.eph_up.T)
            ops["eph_dw"] = put(op.eph_dw)
        self.ops = ops
        self.nnz = op.nnz_estimate()
        self._sharding = sharding

    @staticmethod
    def kernel(ops, v):
        """Pure matvec on the (DimPh, DimDw, DimUp) tensor form; ``ops`` is
        the operand pytree (jit over this directly for explicit-operand
        compilation, e.g. bench.py)."""
        dtype = v.dtype
        out = ops["d"] * v
        out = out + v @ ops["hup_t"]
        out = out + jnp.einsum("de,peu->pdu", ops["hdw"], v,
                               preferred_element_type=dtype)
        if "nl_eb" in ops:
            kk = ops["nl_eb"].shape[0]
            for k in range(kk):
                t = jnp.take(v, ops["nl_eb"][k], axis=1)
                t = jnp.take(t, ops["nl_ua"][k], axis=2)
                out = out + t * (ops["nl_sb"][k][None, :, None] *
                                 ops["nl_sa"][k][None, None, :])
        elif "nl_a" in ops:
            out = out + jnp.einsum("kde,peu,kuv->pdv", ops["nl_b"], v,
                                   ops["nl_a"], preferred_element_type=dtype)
        if "ph_mat" in ops:
            out = out + jnp.einsum("pq,qdu->pdu", ops["ph_mat"], v,
                                   preferred_element_type=dtype)
            ev = ops["eph_d"] * v + v @ ops["eph_up_t"] \
                + jnp.einsum("de,peu->pdu", ops["eph_dw"], v,
                             preferred_element_type=dtype)
            out = out + jnp.einsum("pq,qdu->pdu", ops["ph_x"], ev,
                                   preferred_element_type=dtype)
        return out

    # backward-compatible operand attributes (tests, mesh sharding helpers)
    def __getattr__(self, name):
        ops = self.__dict__.get("ops")
        if ops is not None and name in ops:
            return ops[name]
        if name in ("nl_a", "nl_b", "ph_mat", "ph_x", "eph_d", "eph_up_t",
                    "eph_dw"):
            return None
        raise AttributeError(name)

    @property
    def has_ph(self) -> bool:
        return "ph_mat" in self.ops

    def apply3(self, v):
        """Matvec on the (DimPh, DimDw, DimUp) tensor form."""
        return KronMatvec.kernel(self.ops, v)

    def __call__(self, v):
        v3 = v.reshape(self.shape3)
        if self._sharding is not None:
            v3 = jax.lax.with_sharding_constraint(v3, self._sharding)
        out = self.apply3(v3)
        if self._sharding is not None:
            out = jax.lax.with_sharding_constraint(out, self._sharding)
        return out.reshape(-1)


def _split2(x):
    """Double-single decomposition: x ≈ hi + lo with hi, lo f32."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


class MixedKronMatvec:
    """f64-in/f64-out sector matvec computed in double-single f32.

    Splits H and v into (hi, lo) f32 pairs and evaluates
    H·v ≈ Hhi·vhi (f32 HIGHEST) + Hhi·vlo + Hlo·vhi, achieving ~3e-7
    relative matvec error from f32 arithmetic only. Pair with an exact
    f64 Rayleigh-Ritz refinement of the converged subspace
    (ops.lanczos.eigsh_lowest refine_matvec) for full-precision eigenvalues.
    """

    def __init__(self, op: NormalSectorOp,
                 sharding: Optional[jax.sharding.NamedSharding] = None):
        base = KronMatvec(op, dtype=jnp.float32, sharding=sharding)
        self.shape3 = base.shape3
        self.dim = base.dim
        self.dtype = jnp.float64
        self.nnz = base.nnz
        self._sharding = sharding
        ops = dict(base.ops)
        src = {"hup_t": op.hup.T, "hdw": op.hdw, "d": op.d}
        if op.ph_mat is not None:
            src.update({"eph_up_t": op.eph_up.T, "eph_dw": op.eph_dw,
                        "eph_d": op.eph_d, "ph_mat": op.ph_mat,
                        "ph_x": op.ph_x})
        # lo-parts of the dense factors and diagonals
        for name, arr in src.items():
            hi, lo = _split2(jnp.asarray(np.asarray(arr), jnp.float64))
            ops[name] = jax.device_put(hi)
            ops[name + "_lo"] = jax.device_put(lo)
        self.ops = ops

    @staticmethod
    def kernel_pair(ops, vhi, vlo=None):
        """(main, corr) f32 planes with H v ≈ main + corr.  ``vlo`` carries
        the input's double-single low part (None for a pure-f32 input — the
        DS Lanczos recurrences, whose vectors are f32 by construction)."""
        hp = jax.lax.Precision.HIGHEST
        # main terms (f32, HIGHEST matmul accumulation)
        main = ops["d"] * vhi
        main = main + jnp.einsum("pdu,uv->pdv", vhi, ops["hup_t"], precision=hp)
        main = main + jnp.einsum("de,peu->pdu", ops["hdw"], vhi, precision=hp)
        # first-order corrections (DEFAULT precision is ample: they are
        # already ~1e-7 relative)
        corr = ops["d_lo"] * vhi
        corr = corr + vhi @ ops["hup_t_lo"]
        corr = corr + jnp.einsum("de,peu->pdu", ops["hdw_lo"], vhi)
        if vlo is not None:
            corr = corr + ops["d"] * vlo
            corr = corr + vlo @ ops["hup_t"]
            corr = corr + jnp.einsum("de,peu->pdu", ops["hdw"], vlo)
        if "nl_eb" in ops:
            for k in range(ops["nl_eb"].shape[0]):
                sgn = (ops["nl_sb"][k][None, :, None] *
                       ops["nl_sa"][k][None, None, :])
                srcs = [(vhi, "main")] + ([(vlo, "corr")] if vlo is not None
                                          else [])
                for src, dst in srcs:
                    t = jnp.take(src, ops["nl_eb"][k], axis=1)
                    t = jnp.take(t, ops["nl_ua"][k], axis=2) * sgn
                    if dst == "main":
                        main = main + t
                    else:
                        corr = corr + t
        elif "nl_a" in ops:
            main = main + jnp.einsum("kde,peu,kuv->pdv", ops["nl_b"], vhi,
                                     ops["nl_a"], precision=hp)
            if vlo is not None:
                corr = corr + jnp.einsum("kde,peu,kuv->pdv", ops["nl_b"],
                                         vlo, ops["nl_a"])
        if "ph_mat" in ops:
            main = main + jnp.einsum("pq,qdu->pdu", ops["ph_mat"], vhi,
                                     precision=hp)
            corr = corr + jnp.einsum("pq,qdu->pdu", ops["ph_mat_lo"], vhi)
            ev = ops["eph_d"] * vhi + vhi @ ops["eph_up_t"] \
                + jnp.einsum("de,peu->pdu", ops["eph_dw"], vhi, precision=hp)
            if vlo is not None:
                corr = corr + jnp.einsum("pq,qdu->pdu", ops["ph_mat"], vlo)
                ev = ev + ops["eph_d"] * vlo + vlo @ ops["eph_up_t"] \
                    + jnp.einsum("de,peu->pdu", ops["eph_dw"], vlo)
            main = main + jnp.einsum("pq,qdu->pdu", ops["ph_x"], ev,
                                     precision=hp)
        return main, corr

    @staticmethod
    def kernel(ops, v64):
        vhi, vlo = _split2(v64)
        main, corr = MixedKronMatvec.kernel_pair(ops, vhi, vlo)
        return main.astype(jnp.float64) + corr.astype(jnp.float64)

    def apply3(self, v):
        return MixedKronMatvec.kernel(self.ops, v)

    def pair(self, v32):
        """f32 flat vector -> (main, corr) f32 flat planes (DS Lanczos)."""
        v3 = v32.astype(jnp.float32).reshape(self.shape3)
        if self._sharding is not None:
            v3 = jax.lax.with_sharding_constraint(v3, self._sharding)
        main, corr = MixedKronMatvec.kernel_pair(self.ops, v3)
        if self._sharding is not None:
            main = jax.lax.with_sharding_constraint(main, self._sharding)
            corr = jax.lax.with_sharding_constraint(corr, self._sharding)
        return main.reshape(-1), corr.reshape(-1)

    def __call__(self, v):
        v3 = v.reshape(self.shape3)
        if self._sharding is not None:
            v3 = jax.lax.with_sharding_constraint(v3, self._sharding)
        out = self.apply3(v3)
        if self._sharding is not None:
            out = jax.lax.with_sharding_constraint(out, self._sharding)
        return out.reshape(-1)


def _ell_rows(m: np.ndarray):
    """Row-wise ELL factorization of a sparse (n, n) matrix: returns
    (cols (n, K) int32, vals (n, K) f64) with K = max nnz/row."""
    m = np.asarray(m, np.float64)
    n = m.shape[0]
    kmax = max(1, int((np.abs(m) > 0).sum(axis=1).max()))
    cols = np.zeros((n, kmax), np.int32)
    vals = np.zeros((n, kmax))
    for i in range(n):
        nz = np.nonzero(m[i])[0]
        cols[i, :len(nz)] = nz
        vals[i, :len(nz)] = m[i, nz]
    return (jax.device_put(jnp.asarray(cols)),
            jax.device_put(jnp.asarray(vals)))


class ExactKronMatvec:
    """EXACT f64 normal-mode matvec with SPARSE factor application.

    The spin-factor matrices carry only ~Ns nonzeros per row, so an ELL
    gather + f64 elementwise FMA applies them in O(dim * Ns) work instead
    of the dense factor matmuls' O(dim^1.5), with exact f64 products.
    Semantics match
    KronMatvec(dtype=f64) (pinned in tests/test_mixed_precision.py)."""

    def __init__(self, op: NormalSectorOp,
                 sharding: Optional[jax.sharding.NamedSharding] = None):
        self.shape3 = (op.sector.dim_ph, op.hdw.shape[0], op.hup.shape[0])
        self.dim = int(np.prod(self.shape3))
        self.dtype = jnp.float64
        self.nnz = op.nnz_estimate()
        self._sharding = sharding
        put = lambda x: jax.device_put(jnp.asarray(np.asarray(x),
                                                   jnp.float64))
        self.d = put(op.d)
        self.hup_ell = _ell_rows(op.hup)
        self.hdw_ell = _ell_rows(op.hdw)
        self.nl = None
        self.nl_dense = None
        if getattr(op, "nl_perm", None) is not None:
            src_a, sgn_a, src_b, sgn_b = op.nl_perm
            self.nl = (jax.device_put(jnp.asarray(src_a)), put(sgn_a),
                       jax.device_put(jnp.asarray(src_b)), put(sgn_b))
        elif getattr(op, "nl_a", None) is not None:
            pa = _perm_factor(op.nl_a)
            pb = _perm_factor(op.nl_b)
            if pa is not None and pb is not None:
                self.nl = (jax.device_put(jnp.asarray(pa[0])), put(pa[1]),
                           jax.device_put(jnp.asarray(pb[0])), put(pb[1]))
            else:
                self.nl_dense = (put(np.swapaxes(op.nl_a, 1, 2)),
                                 put(op.nl_b))
        self.has_ph = op.ph_mat is not None
        if self.has_ph:
            self.ph_mat = np.asarray(op.ph_mat, np.float64)
            self.ph_x = np.asarray(op.ph_x, np.float64)
            self.eph_d = put(op.eph_d)
            self.eph_up_ell = _ell_rows(op.eph_up)
            self.eph_dw_ell = _ell_rows(op.eph_dw)

    @staticmethod
    def _up(v, ell):
        cols, vals = ell
        t = jnp.take(v, cols, axis=2)              # (ph, ddw, dup, K)
        return jnp.sum(t * vals[None, None, :, :], axis=3)

    @staticmethod
    def _dw(v, ell):
        cols, vals = ell
        t = jnp.take(v, cols, axis=1)              # (ph, ddw, K, dup)
        return jnp.sum(t * vals[None, :, :, None], axis=2)

    def _ph_small(self, m, v):
        """(dim_ph, dim_ph) small matrix on the phonon axis as a python
        loop of f64 scalar*tensor FMAs over its nonzeros."""
        rows = []
        for p in range(m.shape[0]):
            acc = None
            for q in range(m.shape[1]):
                if m[p, q] == 0.0:
                    continue
                term = m[p, q] * v[q]
                acc = term if acc is None else acc + term
            rows.append(acc if acc is not None else jnp.zeros_like(v[0]))
        return jnp.stack(rows)

    def apply3(self, v):
        v = v.astype(jnp.float64)
        out = self.d * v
        out = out + self._up(v, self.hup_ell)
        out = out + self._dw(v, self.hdw_ell)
        if self.nl is not None:
            src_a, sgn_a, src_b, sgn_b = self.nl
            for k in range(src_b.shape[0]):
                t = jnp.take(v, src_b[k], axis=1)
                t = jnp.take(t, src_a[k], axis=2)
                out = out + t * (sgn_b[k][None, :, None]
                                 * sgn_a[k][None, None, :])
        elif self.nl_dense is not None:
            nl_a, nl_b = self.nl_dense
            out = out + jnp.einsum("kde,peu,kuv->pdv", nl_b, v, nl_a,
                                   preferred_element_type=jnp.float64)
        if self.has_ph:
            out = out + self._ph_small(self.ph_mat, v)
            ev = self.eph_d * v + self._up(v, self.eph_up_ell) \
                + self._dw(v, self.eph_dw_ell)
            out = out + self._ph_small(self.ph_x, ev)
        return out

    def __call__(self, v):
        v3 = v.reshape(self.shape3)
        if self._sharding is not None:
            v3 = jax.lax.with_sharding_constraint(v3, self._sharding)
        out = self.apply3(v3)
        if self._sharding is not None:
            out = jax.lax.with_sharding_constraint(out, self._sharding)
        return out.reshape(-1)


class EllMatvec:
    """Padded-ELL sparse matvec: out[i] = Σ_k vals[i,k] * v[cols[i,k]].

    Rows are padded to a fixed K with (col=i, val=0) entries. ``cols`` int32.
    """

    def __init__(self, cols: np.ndarray, vals: np.ndarray, dtype=jnp.float64,
                 nnz: Optional[int] = None):
        assert cols.shape == vals.shape and cols.ndim == 2
        self.dim = cols.shape[0]
        self.k = cols.shape[1]
        self.dtype = dtype
        self.cols = jax.device_put(jnp.asarray(cols, jnp.int32))
        self.vals = device_put_cplx(vals, dtype)
        self.nnz = int(nnz if nnz is not None else np.count_nonzero(vals))

    def __call__(self, v):
        gathered = jnp.take(v, self.cols, axis=0)        # (dim, K)
        return jnp.sum(self.vals * gathered, axis=1)


class JointMatvec:
    """superc/nonsu2 sector matvec: padded-ELL electronic H batched over the
    phonon axis, plus phonon and electron-phonon Kronecker terms.

    v is flat (dim_ph * dim_el); internally (dim_ph, dim_el)."""

    def __init__(self, op, dtype=jnp.complex128):
        self.dim_el = op.dim_el
        self.dim_ph = op.sector.dim_ph
        self.dim = self.dim_el * self.dim_ph
        self.dtype = dtype
        cols, vals = op.ell()
        self.cols = jax.device_put(jnp.asarray(cols, jnp.int32))
        self.vals = device_put_cplx(vals, dtype)
        self.has_ph = op.ph_mat is not None
        if self.has_ph:
            self.ph_mat = device_put_cplx(op.ph_mat, dtype)
            self.ph_x = device_put_cplx(op.ph_x, dtype)
            self.eph_diag = device_put_cplx(op.eph_diag, dtype)
            if op.eph_rows is not None and len(op.eph_rows):
                import numpy as _np
                e = _np.zeros((self.dim_el, self.dim_el), dtype=complex)
                _np.add.at(e, (op.eph_rows, op.eph_cols), op.eph_vals)
                self.eph_dense = device_put_cplx(e, dtype)
            else:
                self.eph_dense = None
        self.nnz = op.nnz_estimate()
        # set by parallel.mesh.shard_joint_matvec: padded ELL row count (the
        # tables are row-sharded over the mesh; the gather makes GSPMD
        # all-gather v — the reference's Allgatherv row split)
        self._el_padded = None

    def __call__(self, v):
        v2 = v.reshape(self.dim_ph, self.dim_el)
        gathered = jnp.take(v2, self.cols, axis=1)          # (dp, de[p], K)
        out = jnp.sum(self.vals[None, :, :] * gathered, axis=-1)
        if self._el_padded is not None and self._el_padded != self.dim_el:
            out = out[:, :self.dim_el]
        if self.has_ph:
            out = out + self.ph_mat @ v2
            ev = self.eph_diag[None, :] * v2
            if self.eph_dense is not None:
                ev = ev + v2 @ self.eph_dense.T
            out = out + self.ph_x @ ev
        return out.reshape(-1)


class JointMatvecDirect:
    """Memory-lean 'direct' joint matvec (the ``ed_sparse_H=F`` analog,
    reference ED_*/direct/ on-the-fly HxV): applies the raw COO term list
    with a scatter-add instead of materializing the padded ELL tables —
    O(nnz) storage instead of O(dim*K), trading the ELL's regular gather
    for XLA scatter-adds."""

    def __init__(self, op, dtype=jnp.complex128):
        self.dim_el = op.dim_el
        self.dim_ph = op.sector.dim_ph
        self.dim = self.dim_el * self.dim_ph
        self.dtype = dtype
        self.rows = jax.device_put(jnp.asarray(op.rows, jnp.int32))
        self.cols = jax.device_put(jnp.asarray(op.cols, jnp.int32))
        self.vals = device_put_cplx(op.vals, dtype)
        self.diag = device_put_cplx(op.diag, dtype)
        self.has_ph = op.ph_mat is not None
        if self.has_ph:
            self.ph_mat = device_put_cplx(op.ph_mat, dtype)
            self.ph_x = device_put_cplx(op.ph_x, dtype)
            self.eph_diag = device_put_cplx(op.eph_diag, dtype)
            if op.eph_rows is not None and len(op.eph_rows):
                self.eph_rows = jax.device_put(jnp.asarray(op.eph_rows, jnp.int32))
                self.eph_cols = jax.device_put(jnp.asarray(op.eph_cols, jnp.int32))
                self.eph_vals = jax.device_put(jnp.asarray(op.eph_vals, dtype))
            else:
                self.eph_rows = None
        self.nnz = op.nnz_estimate()

    def __call__(self, v):
        v2 = v.reshape(self.dim_ph, self.dim_el)
        out = self.diag[None, :] * v2
        out = out.at[:, self.rows].add(self.vals[None, :] * v2[:, self.cols])
        if self.has_ph:
            out = out + self.ph_mat @ v2
            ev = self.eph_diag[None, :] * v2
            if self.eph_rows is not None:
                ev = ev.at[:, self.eph_rows].add(
                    self.eph_vals[None, :] * v2[:, self.eph_cols])
            out = out + self.ph_x @ ev
        return out.reshape(-1)


class DenseMatvec:
    """Explicit dense H for small sectors and tests."""

    def __init__(self, h: np.ndarray, dtype=jnp.float64):
        self.h = jax.device_put(jnp.asarray(h, dtype))
        self.dim = h.shape[0]
        self.dtype = dtype
        self.nnz = int(np.count_nonzero(h))

    def __call__(self, v):
        return self.h @ v
