"""On-device Krylov eigensolvers.

Replaces the reference's P-ARPACK / in-house Lanczos stack (SciFortran
sp_eigh / sp_lanc_eigh / sp_lanc_tridiag used from ED_DIAG_NORMAL.f90:119-252)
with two jit-compiled primitives:

* :func:`lanczos_sweep` — fixed-size Lanczos factorization with full
  reorthogonalization (basis kept on device), driven by a host-side
  deflation/restart loop in :func:`eigsh_lowest` that delivers the ``nev``
  lowest eigenpairs to ARPACK-grade accuracy.
* :func:`lanczos_tridiag` — storage-free Lanczos tridiagonalization (no
  reorthogonalization) for the Green's-function continued fractions
  (reference tridiag_Hv_sector_*, lanc_ngfiter moments).

Everything runs under jit with static shapes; the matvec is a closure over
device-resident operator factors (ops.matvec).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# sectors at least this large keep the Lanczos basis in f32/c64 (memory);
# their eigenvectors come back at that precision unless refined
F32_BASIS_MIN_DIM = 1 << 25

# ---------------------------------------------------------------------------
# jitted micro-helpers.  The restart driver runs on the host between jitted
# sweeps; every device op it issues is itself jitted, so each costs one
# cached dispatch instead of a chain of eager ops.
# ---------------------------------------------------------------------------

def _jitted(fn, owner=None, attr="_edtpu_jit"):
    """jit with a cache hung on the callable (or an explicit owner)."""
    tgt = owner if owner is not None else fn
    f = getattr(tgt, attr, None)
    if f is None:
        f = jax.jit(fn)
        try:
            setattr(tgt, attr, f)
        except AttributeError:
            pass
    return f


@jax.jit
def _j_norm(v):
    return jnp.linalg.norm(v)


@jax.jit
def _j_scale(v, s):
    return v / s


@jax.jit
def _j_normalize_or(v, fb):
    n = jnp.linalg.norm(v)
    return jnp.where(n > 1e-12, v / jnp.where(n > 0, n, 1.0), fb)


@jax.jit
def _stack_impl(*vs):
    return jnp.stack(vs)


def _j_stack(vs):
    return _stack_impl(*vs)


@partial(jax.jit, static_argnums=(0, 1))
def _j_zeros(shape, dtype):
    return jnp.zeros(shape, dtype)


@jax.jit
def _j_row(a, j):
    return a[j]


@jax.jit
def _j_deflate(lk, v):
    # projections run at the BASIS dtype: promoting a reduced-precision
    # (m, dim) basis to the vector's f64 materializes multiple
    # multi-GB temps (the r03 gs OOM: 42.6G HBM for dim 1.2e7, m 36);
    # the f32-coefficient error (~1e-7) matches the basis's own precision
    hp = jax.lax.Precision.HIGHEST
    proj = jnp.matmul(jnp.conj(lk), v.astype(lk.dtype), precision=hp)
    return v - jnp.matmul(proj, lk, precision=hp).astype(v.dtype)


@jax.jit
def _j_deflate_one(e, u):
    # vdot lowers to dot_general — explicit HIGHEST (an accelerator's
    # DEFAULT f32 matmul may run in bf16 or TF32)
    p = jnp.matmul(jnp.conj(e)[None, :], u[:, None],
                   precision=jax.lax.Precision.HIGHEST)[0, 0]
    return u - p * e


@jax.jit
def _j_ritz(t_real, vd):
    """(n, k) real host coefficients x (k, dim) device basis.
    Explicit HIGHEST everywhere a basis is contracted: DEFAULT f32 matmul
    precision may be bf16 or TF32 on an accelerator — extraction/deflation
    at that precision injects ~1e-3..1e-2 errors into eigenvectors."""
    return jnp.matmul(t_real.astype(vd.dtype), vd,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _j_vdot_real(a, b):
    return jnp.vdot(a, b).real


@jax.jit
def _j_axpy(a, s, b):
    return a - s * b


@partial(jax.jit, static_argnums=(1, 2))
def _j_randn_t(key, dim, dtype):
    v = jax.random.normal(key, (dim,), dtype=jnp.float64)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        v = v + 1j * jax.random.normal(jax.random.fold_in(key, 1), (dim,),
                                       dtype=jnp.float64)
    return v.astype(dtype)


@partial(jax.jit, static_argnums=(1,))
def _j_astype(v, dtype):
    return v.astype(dtype)


def _as_dev(v, dtype):
    """Move v to device at dtype without eager device casts or complex
    host->device transfers (ops.matvec.device_put_cplx)."""
    if isinstance(v, jax.Array):
        return v if v.dtype == dtype else _j_astype(v, dtype)
    from .matvec import device_put_cplx
    return device_put_cplx(np.asarray(v), dtype)


def _sweep_body(matvec, reorth_every):
    def body(carry, i):
        V, alphas, betas, v, beta_prev, v_prev = carry
        store = V.dtype
        w = matvec(v)
        alpha = jnp.vdot(v, w).real
        w = w - alpha * v - beta_prev * v_prev
        # full reorthogonalization against the stored basis (two passes).
        # V may be stored at reduced precision (huge sectors, see
        # lanczos_sweep) — the projection matmuls then run at the storage
        # dtype so no full-basis upcast copy is materialized; the ~1e-7
        # orthogonality floor is at the mixed-matvec noise level and the
        # exact Rayleigh-Ritz refine recovers full precision.
        m = V.shape[0]
        mask = (jnp.arange(m) <= i).astype(store)
        hp = jax.lax.Precision.HIGHEST
        for _ in range(2):
            # explicit HIGHEST: DEFAULT f32 matmul precision may be bf16 or
            # TF32 on an accelerator — reorthogonalization at that precision
            # silently destroys the basis
            proj = jax.lax.dot_general(jnp.conj(V), w.astype(store),
                                       (((1,), (0,)), ((), ())),
                                       precision=hp)
            w = w - jax.lax.dot_general(proj * mask, V,
                                        (((0,), (0,)), ((), ())),
                                        precision=hp).astype(w.dtype)
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.where(beta > 0, beta, 1.0), 0.0 * w)
        V = V.at[i + 1].set(v_next.astype(store))
        alphas = alphas.at[i].set(alpha)
        betas = betas.at[i].set(beta.real.astype(alphas.dtype))
        return (V, alphas, betas, v_next, beta.astype(v.dtype), v), None
    return body


@partial(jax.jit, static_argnums=(0, 2))
def lanczos_sweep(matvec, v0, m: int, locked=None):
    """Run an m-step Lanczos factorization from ``v0``.

    Returns (alphas[m], betas[m], V[m+1, dim]): T = tridiag(alphas, betas[:-1]),
    betas[m-1] is the residual coupling. ``locked`` (L, dim) converged
    eigenvectors are projected out of every Krylov vector."""
    dim = v0.shape[0]
    dtype = v0.dtype
    rdtype = jnp.zeros(0, dtype).real.dtype

    if locked is not None and locked.shape[0] > 0:
        def mv(v):
            return _j_deflate(locked, matvec(v))
    else:
        def mv(v):
            return matvec(v)

    v0 = v0 / jnp.linalg.norm(v0)
    if locked is not None and locked.shape[0] > 0:
        v0 = _j_deflate(locked, v0)
        v0 = v0 / jnp.linalg.norm(v0)

    # huge sectors: the (m+1, dim) Krylov basis at f64 plus the scan's carry
    # copy would crowd the device (~27 GB at dim 2^25, m=48); store the
    # basis at single precision there — reorthogonalization floors at the
    # f32 level, which the exact Rayleigh-Ritz refine absorbs.
    store = dtype
    if dim >= F32_BASIS_MIN_DIM:
        store = jnp.complex64 if jnp.issubdtype(dtype, jnp.complexfloating) \
            else jnp.float32
    V = jnp.zeros((m + 1, dim), store).at[0].set(v0.astype(store))
    alphas = jnp.zeros(m, rdtype)
    betas = jnp.zeros(m, rdtype)
    carry = (V, alphas, betas, v0, jnp.asarray(0.0, dtype), jnp.zeros(dim, dtype))
    body = _sweep_body(mv, 1)
    carry, _ = jax.lax.scan(body, carry, jnp.arange(m))
    V, alphas, betas, *_ = carry
    return alphas, betas, V


def _dot64(a, b, chunk: int = 2048):
    """<a|b> of f32/c64 vectors with f64-accumulated chunk sums.

    Keeps the DS recurrences in f32 memory traffic: f32 products, f32 row
    sums over
    ``chunk``-sized tiles (XLA lane-tree reduction, error ~eps32*sqrt(chunk)
    per tile), then an f64 sum of the ~n/chunk tile results — total relative
    error ~1e-7."""
    p = jnp.conj(a) * b
    n = p.shape[0]
    pad = (-n) % chunk
    if pad:
        p = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
    s = jnp.sum(p.reshape(-1, chunk), axis=1)
    acc = (jnp.complex128 if jnp.issubdtype(p.dtype, jnp.complexfloating)
           else jnp.float64)
    return jnp.sum(s.astype(acc))


@partial(jax.jit, static_argnums=(0, 2))
def lanczos_tridiag(matvec, v0, m: int):
    """Storage-free m-step tridiagonalization (GF moments; no reorth).

    Returns (alphas[m], betas[m-1], norm0) where norm0 = |v0| (the caller
    keeps <v0|v0> as the spectral weight; v0 need not be normalized)."""
    dim = v0.shape[0]
    dtype = v0.dtype
    rdtype = jnp.zeros(0, dtype).real.dtype
    norm0 = jnp.linalg.norm(v0)
    v = v0 / jnp.where(norm0 > 0, norm0, 1.0)

    def body(carry, i):
        v, v_prev, beta_prev = carry
        w = matvec(v)
        alpha = jnp.vdot(v, w).real
        w = w - alpha * v - beta_prev * v_prev
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.where(beta > 0, beta, 1.0), 0.0 * w)
        return (v_next, v, beta.astype(dtype)), (alpha.astype(rdtype),
                                                 beta.real.astype(rdtype))

    (_, _, _), (alphas, betas) = jax.lax.scan(
        body, (v, jnp.zeros(dim, dtype), jnp.asarray(0.0, dtype)), jnp.arange(m))
    return alphas, betas[:-1], norm0


@partial(jax.jit, static_argnums=(0, 2))
def lanczos_tridiag_ds(op, v0, m: int):
    """GF tridiagonalization on the double-single pair matvec.

    The recurrence vectors live in f32 (c64 for complex), while every inner
    product is f64-chunk-accumulated (:func:`_dot64`), keeping the
    tridiagonal coefficients at the ~1e-7 noise floor of the DS matvec
    itself.  ``op`` must expose ``pair(v32) -> (main, corr)`` with
    H v = main + corr (ops.matvec.MixedKronMatvec,
    models.joint_kron.MixedJointKron).  Same contract as :func:`lanczos_tridiag`:
    returns (alphas[m] f64, betas[m-1] f64, norm0 f64)."""
    cplx = jnp.issubdtype(v0.dtype, jnp.complexfloating)
    store = jnp.complex64 if cplx else jnp.float32
    rone = jnp.float32
    v0 = v0.astype(store)
    norm0 = jnp.sqrt(_dot64(v0, v0).real)
    v = v0 * jnp.where(norm0 > 0, 1.0 / jnp.where(norm0 > 0, norm0, 1.0),
                       0.0).astype(rone)

    def body(carry, i):
        v, v_prev, beta_prev = carry          # v f32/c64; beta_prev f64
        main, corr = op.pair(v)
        alpha = (_dot64(v, main) + _dot64(v, corr)).real
        w = (main + corr) - alpha.astype(rone) * v \
            - beta_prev.astype(rone) * v_prev
        beta = jnp.sqrt(_dot64(w, w).real)
        v_next = w * jnp.where(
            beta > 0, 1.0 / jnp.where(beta > 0, beta, 1.0), 0.0).astype(rone)
        return (v_next, v, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        body, (v, jnp.zeros_like(v), jnp.asarray(0.0, jnp.float64)),
        jnp.arange(m))
    return alphas, betas[:-1], norm0


@partial(jax.jit, static_argnums=(0, 2))
def lanczos_tridiag_ds_batch(op, v0s, m: int):
    """vmapped :func:`lanczos_tridiag_ds` (B same-sector GF chains, one
    launch).  Returns (alphas (B,m), betas (B,m-1), norm0s (B,))."""
    return jax.vmap(lambda v: lanczos_tridiag_ds(op, v, m))(v0s)


@partial(jax.jit, static_argnums=(0, 2))
def lanczos_sweep_ds(op, v0, m: int, locked=None):
    """Eigensolver Lanczos sweep on the double-single pair matvec: f32
    Krylov basis, full two-pass reorthogonalization with HIGHEST-precision
    thin matmuls (a reduced-precision DEFAULT matmul is useless for
    orthogonality), f64-chunk-accumulated recurrence scalars.
    Orthogonality floors at the DS matvec noise (~1e-7), which the exact
    Rayleigh-Ritz polish absorbs.
    Same contract as :func:`lanczos_sweep` (V returned f32)."""
    cplx = jnp.issubdtype(v0.dtype, jnp.complexfloating)
    store = jnp.complex64 if cplx else jnp.float32
    rone = jnp.float32
    hp = jax.lax.Precision.HIGHEST
    dim = v0.shape[0]
    v0 = v0.astype(store)
    have_locked = locked is not None and locked.shape[0] > 0
    if have_locked:
        locked = locked.astype(store)

    def defl(w):
        if not have_locked:
            return w
        proj = jax.lax.dot_general(jnp.conj(locked), w,
                                   (((1,), (0,)), ((), ())), precision=hp)
        return w - jax.lax.dot_general(proj, locked,
                                       (((0,), (0,)), ((), ())), precision=hp)

    nrm0 = jnp.sqrt(_dot64(v0, v0).real)
    v0 = v0 * jnp.where(nrm0 > 0, 1.0 / jnp.where(nrm0 > 0, nrm0, 1.0),
                        0.0).astype(rone)
    if have_locked:
        v0 = defl(v0)
        n2 = jnp.sqrt(_dot64(v0, v0).real)
        v0 = v0 * jnp.where(n2 > 0, 1.0 / jnp.where(n2 > 0, n2, 1.0),
                            0.0).astype(rone)

    V = jnp.zeros((m + 1, dim), store).at[0].set(v0)
    alphas = jnp.zeros(m, jnp.float64)
    betas = jnp.zeros(m, jnp.float64)

    def body(carry, i):
        V, alphas, betas, v, beta_prev, v_prev = carry
        main, corr = op.pair(v)
        w = defl(main + corr)
        alpha = _dot64(v, w).real
        w = w - alpha.astype(rone) * v - beta_prev.astype(rone) * v_prev
        mask = (jnp.arange(m + 1) <= i).astype(rone)
        for _ in range(2):
            proj = jax.lax.dot_general(jnp.conj(V), w,
                                       (((1,), (0,)), ((), ())), precision=hp)
            w = w - jax.lax.dot_general(proj * mask, V,
                                        (((0,), (0,)), ((), ())),
                                        precision=hp)
        beta = jnp.sqrt(_dot64(w, w).real)
        v_next = w * jnp.where(
            beta > 0, 1.0 / jnp.where(beta > 0, beta, 1.0), 0.0).astype(rone)
        V = V.at[i + 1].set(v_next)
        alphas = alphas.at[i].set(alpha)
        betas = betas.at[i].set(beta)
        return (V, alphas, betas, v_next, beta, v), None

    carry = (V, alphas, betas, v0, jnp.asarray(0.0, jnp.float64),
             jnp.zeros_like(v0))
    carry, _ = jax.lax.scan(body, carry, jnp.arange(m))
    V, alphas, betas, *_ = carry
    return alphas, betas, V


@partial(jax.jit, static_argnums=(0, 1, 4))
def lanczos_sweep_ds_ops(kernel_pair, shape3, ops, v0, m: int, locked=None):
    """Functional-operand DS sweep: the matvec is
    ``kernel_pair(ops, vhi3) -> (main3, corr3)`` on the ``shape3`` tensor
    form with ``ops`` a traced operand pytree — the vmappable form of
    :func:`lanczos_sweep_ds` (same-shape sectors batch over stacked operand
    pytrees; the reference runs sectors strictly serially,
    ED_DIAG_NORMAL.f90:108)."""

    class _Op:
        def pair(self, v):
            m_, c_ = kernel_pair(ops, v.reshape(shape3))
            return m_.reshape(-1), c_.reshape(-1)
    return lanczos_sweep_ds(_Op(), v0, m, locked)


@partial(jax.jit, static_argnums=(0, 1, 4))
def lanczos_sweep_ds_batch(kernel_pair, shape3, ops_stacked, v0s, m: int,
                           locked_stacked=None):
    """B same-shape sectors, one launch: vmap of
    :func:`lanczos_sweep_ds_ops` over stacked operands / start vectors /
    locked blocks (pad per-lane locked lists with zero rows — deflating
    against a zero vector is the identity)."""
    def one(ops, v0, lk):
        return lanczos_sweep_ds_ops(kernel_pair, shape3, ops, v0, m, lk)
    if locked_stacked is None:
        return jax.vmap(lambda o, v: lanczos_sweep_ds_ops(
            kernel_pair, shape3, o, v, m, None))(ops_stacked, v0s)
    return jax.vmap(one)(ops_stacked, v0s, locked_stacked)


@partial(jax.jit, static_argnums=(0, 2))
def lanczos_tridiag_batch(matvec, v0s, m: int):
    """Batched storage-free tridiagonalization: one launch runs B
    independent GF Lanczos chains against the SAME operator (vmap over the
    start vectors — the batched form of the reference's per-channel
    tridiag_Hv_sector loop, ED_GF_NORMAL.f90).  Returns (alphas (B,m),
    betas (B,m-1), norm0s (B,))."""
    return jax.vmap(lambda v: lanczos_tridiag(matvec, v, m))(v0s)


def eigsh_lowest(matvec: Callable, dim: int, nev: int, dtype=jnp.float64,
                 m: Optional[int] = None, tol: float = 1e-12,
                 max_restarts: int = 60, v0: Optional[np.ndarray] = None,
                 key=None, refine_matvec: Optional[Callable] = None,
                 stats: Optional[dict] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``nev`` lowest eigenpairs by restarted deflated Lanczos.

    Host-driven outer loop (a handful of restarts), jitted inner sweeps.
    Returns (evals[nev], evecs[nev, dim]) sorted ascending.

    ``refine_matvec``: exact (f64) matvec for a final Rayleigh-Ritz
    rotation of the converged subspace — used when ``matvec`` itself runs
    in reduced precision (MixedKronMatvec): the subspace converges under
    the fast matvec, then nev exact matvecs restore full-precision
    eigenvalues (error ~ ||r||^2 / gap instead of ~ matvec noise).

    ``stats``: optional dict the solver fills with a wall-clock breakdown —
    ``n_restarts``, ``n_matvecs`` (sweep matvec count), ``sweep_s`` (list of
    per-restart sweep+fetch seconds; element 0 includes jit compile),
    ``polish_s`` (list of per-vector polish seconds), ``polish_rounds``,
    ``polish_matvecs`` (exact+DS matvecs inside the polish)."""
    nev = min(nev, dim)
    jm = getattr(matvec, "jmap", None)
    if dim <= 128:
        # tiny spaces: materialize H by matvec columns and eigh directly —
        # avoids per-shape jit churn and Lanczos breakdown handling
        eye = jnp.eye(dim, dtype=dtype)
        h = np.stack([np.asarray(matvec(eye[i])) for i in range(dim)], axis=1)
        vals, vecs = np.linalg.eigh(h)
        if jm is None:
            return vals[:nev], jnp.asarray(vecs[:, :nev].T)
        # real-embedded complex operator: each complex state is a 2D real
        # eigenspace {v, Jv}; greedily keep one representative per state
        keep_vals, keep_vecs, defl = [], [], []
        for k in range(dim):
            if len(keep_vals) >= nev:
                break
            u = vecs[:, k].copy()
            for d in defl:
                u -= (d @ u) * d
            nrm = np.linalg.norm(u)
            if nrm < 1e-8:
                continue
            u /= nrm
            keep_vals.append(float(vals[k]))
            keep_vecs.append(u)
            ju = np.asarray(jm(jnp.asarray(u)))
            defl.extend([u, ju / max(np.linalg.norm(ju), 1e-300)])
        return (np.asarray(keep_vals),
                jnp.asarray(np.stack(keep_vecs)))
    if m is None:
        m = min(dim, max(4 * nev + 24, 48))
    m = min(m, dim)
    if key is None:
        key = _jitted(jax.random.PRNGKey)(17)
    if v0 is None:
        v0 = _j_randn_t(key, dim, dtype)
    v0 = _as_dev(v0, dtype)
    if hasattr(matvec, "v0_project"):
        # padded operator spaces (fused kernel): zero the structural padding
        # so spurious zero-modes of the pad block never enter the Krylov space
        v0 = _jitted(matvec.v0_project, owner=matvec, attr="_edtpu_jit_v0p")(v0)

    use_ds = hasattr(matvec, "pair") and getattr(matvec,
                                                 "ds_recurrence_ok", True)
    sweep_fn = lanczos_sweep_ds if use_ds else lanczos_sweep

    import os as _os
    import time as _time
    _dbg = bool(_os.environ.get("EDTPU_DEBUG_EIGSH"))
    _t0 = _time.perf_counter()
    if stats is None:
        stats = {}
    stats.update(n_restarts=0, n_matvecs=0, sweep_s=[], polish_s=[],
                 polish_rounds=0, polish_matvecs=0)
    ds_store = (jnp.complex64 if jnp.issubdtype(dtype, jnp.complexfloating)
                else jnp.float32)
    locked_vecs = []
    locked_vals = []
    # real-embedded complex operators: deflate each converged state's
    # J-partner (J = multiply-by-i) too — it spans the SAME complex state
    defl_extra = []
    start = v0
    for restart in range(max_restarts):
        _ts = _time.perf_counter()
        lk_list = locked_vecs + defl_extra
        locked = (_j_stack(lk_list) if lk_list
                  else _j_zeros((0, dim), ds_store if use_ds else dtype))
        alphas, betas, V = sweep_fn(matvec, start, m, locked)
        a = np.asarray(alphas)
        b = np.asarray(betas)
        stats["n_restarts"] += 1
        stats["n_matvecs"] += m
        stats["sweep_s"].append(round(_time.perf_counter() - _ts, 3))
        if _dbg:
            print(f"[eigsh] restart {restart} sweep+fetch "
                  f"{_time.perf_counter() - _t0:.2f}s locked="
                  f"{len(locked_vals)}", flush=True)
            _t0 = _time.perf_counter()
        # truncate at breakdown (invariant subspace found)
        k_eff = m
        tiny = max(1e-14, 10 * np.finfo(np.float64).eps) * max(1.0, np.abs(a).max())
        for i in range(m - 1):
            if b[i] < tiny:
                k_eff = i + 1
                break
        T = np.diag(a[:k_eff])
        if k_eff > 1:
            T += np.diag(b[:k_eff - 1], 1) + np.diag(b[:k_eff - 1], -1)
        tvals, tvecs = np.linalg.eigh(T)
        beta_last = b[k_eff - 1] if k_eff <= m - 1 else b[m - 1]
        want = nev - len(locked_vals)
        n_take = min(want, k_eff)
        resids = np.abs(beta_last * tvecs[-1, :n_take])
        Vd = _j_take_rows(V, k_eff)
        ritz = _j_ritz(np.asarray(tvecs[:, :n_take].T, np.float64),
                       Vd)                                   # (n_take, dim)
        scale = max(1.0, np.abs(tvals).max())
        newly_converged = 0
        for j in range(n_take):
            if resids[j] < tol * scale or k_eff >= dim - len(locked_vals):
                vec = _j_row(ritz, j)
                if locked_vecs or defl_extra:
                    vec = _j_deflate(_j_stack(locked_vecs + defl_extra),
                                     vec)
                nrm = float(_j_norm(vec))
                if nrm < 1e-10:
                    continue
                locked_vecs.append(_j_scale(vec, nrm))
                locked_vals.append(float(tvals[j]))
                if jm is not None:
                    defl_extra.append(
                        _jitted(jm, owner=matvec,
                                attr="_edtpu_jit_jm")(locked_vecs[-1]))
                newly_converged += 1
            else:
                break
        if len(locked_vals) >= nev:
            break
        # restart from the first unconverged Ritz vector (cast back to the
        # working dtype — the stored basis may be reduced precision; the DS
        # sweep consumes f32 directly, so skip the f64 round-trip there)
        j0 = newly_converged
        if j0 < n_take:
            start = _j_row(ritz, j0) if use_ds \
                else _j_astype(_j_row(ritz, j0), dtype)
        else:
            key = _jitted(jax.random.fold_in)(key, restart + 100)
            start = _j_randn_t(key, dim, dtype)
            if hasattr(matvec, "v0_project"):
                start = _jitted(matvec.v0_project, owner=matvec,
                                attr="_edtpu_jit_v0p")(start)
        start = _j_normalize_or(
            start, v0 if start.dtype == v0.dtype
            else _j_astype(v0, start.dtype))
    else:
        if len(locked_vals) < nev:
            # accept best available Ritz approximations
            for j in range(len(locked_vals), nev):
                idx = j - len(locked_vals)
                if idx < ritz.shape[0]:
                    vec = _j_row(ritz, idx)
                    locked_vecs.append(_j_scale(vec, float(_j_norm(vec))))
                    locked_vals.append(float(tvals[idx]))

    order = np.argsort(locked_vals[:nev])
    vals = np.asarray(locked_vals)[order]
    vecs = _j_stack([locked_vecs[i] for i in order])

    if refine_matvec is not None and vecs.shape[0] > 0:
        # The reduced-precision Lanczos delivers vectors with error
        # ~ matvec_noise/gap; a bare Rayleigh quotient would leave an
        # eigenvalue error quadratic in that. Polish each vector with
        # *exact* matvecs, cluster-aware: near-degenerate partners inside
        # the same sector (gaps ~1e-4) make single-vector Ritz extraction
        # converge at the tiny inner gap — hopeless — while the cluster
        # *subspace* converges at the large outer gap. So each round runs
        # a short exact Lanczos sweep, merges the lowest Ritz cluster with
        # the previous round's cluster block, and resolves individual
        # members by exact Rayleigh-Ritz in that block (Davis-Kahan: the
        # rotation error is then ~ δ²·W/gap_inner, with δ the subspace
        # error, instead of ~ δ).
        # free the restart machinery's multi-GB buffers (last sweep basis,
        # Ritz block, locked stack) before the polish allocates its own
        # f64 Krylov basis — on an 11.8M sector the overlap OOMs the chip
        V = Vd = ritz = locked = None
        locked_vecs = None
        # exact-sweep size: a DS-converged start needs few exact steps;
        # cap the f64 basis near ~1.5 GB on huge sectors
        m_ref = 36 if dim < (1 << 22) else max(12, (1 << 31) // (dim * 8))
        pol_vals, pol_vecs, pol_defl = [], [], []
        if _dbg:
            print(f"[eigsh] restarts done, entering polish "
                  f"{_time.perf_counter() - _t0:.2f}s after last sweep",
                  flush=True)
            _t0 = _time.perf_counter()
        for i in range(vecs.shape[0]):
            _tp = _time.perf_counter()
            val, vec = _cluster_polish(refine_matvec, _j_row(vecs, i),
                                       pol_defl, dim, m_ref=m_ref,
                                       sweep_op=matvec if use_ds else None,
                                       stats=stats)
            stats["polish_s"].append(round(_time.perf_counter() - _tp, 3))
            if _dbg:
                print(f"[eigsh] polish vec {i}: "
                      f"{_time.perf_counter() - _t0:.2f}s", flush=True)
                _t0 = _time.perf_counter()
            pol_vals.append(val)
            pol_vecs.append(vec)
            pol_defl.append(vec)
            if jm is not None:
                pol_defl.append(_jitted(jm, owner=matvec,
                                        attr="_edtpu_jit_jm")(vec))
        order = np.argsort(pol_vals)
        vals = np.asarray(pol_vals)[order]
        vecs = _j_stack([pol_vecs[i] for i in order])
    return vals, vecs


def eigsh_lowest_batch(mvs, nevs, m: Optional[int] = None, tol: float = 2e-6,
                       max_restarts: int = 60):
    """Lowest eigenpairs of B SAME-SHAPE sectors in lockstep batched DS
    sweeps — the batched replacement of the reference's serial sector
    loop (ED_DIAG_NORMAL.f90:108; SURVEY §2.4.1 "sectors are independent").

    ``mvs``: operators sharing ``shape3`` whose class exposes
    ``kernel_pair(ops, vhi3) -> (main3, corr3)`` (ops.matvec.MixedKronMatvec)
    plus ``.ops`` operand pytrees, ``.dim`` and optional ``.exact`` for the
    f64 polish. One ``lanczos_sweep_ds_batch`` launch advances every
    unconverged sector per restart; converged lanes ride along (their extra
    sweeps are wasted work bounded by the group's slowest lane — still far
    ahead of B serial launch sequences). Returns [(vals, vecs), ...]."""
    B = len(mvs)
    dim = mvs[0].dim
    shape3 = mvs[0].shape3
    kernel_pair = type(mvs[0]).kernel_pair
    nev_max = max(nevs)
    if m is None:
        m = min(dim, max(4 * nev_max + 24, 48))
    m = min(m, dim)
    ops_stacked = jax.tree.map(lambda *xs: _stack_impl(*xs),
                               *[mv.ops for mv in mvs])

    key = _jitted(jax.random.PRNGKey)(23)
    starts = [_j_randn_t(_jitted(jax.random.fold_in)(key, b), dim,
                         jnp.float64) for b in range(B)]
    locked_vecs = [[] for _ in range(B)]
    locked_vals = [[] for _ in range(B)]
    done = [False] * B
    # last unconverged Ritz block per lane: (ritz_rows, tvals, newly) — the
    # distinct (deflated) approximations a never-converged lane falls back
    # to, mirroring the serial eigsh_lowest tail
    last_ritz = [None] * B
    lmax_pad = max(1, nev_max)

    for restart in range(max_restarts):
        lk = jnp.zeros((B, lmax_pad, dim), jnp.float32)
        for b in range(B):
            for j, v in enumerate(locked_vecs[b][:lmax_pad]):
                lk = lk.at[b, j].set(v.astype(jnp.float32))
        v0s = _j_stack([s.astype(jnp.float32) if s.dtype != jnp.float32
                        else s for s in starts])
        alphas, betas, V = lanczos_sweep_ds_batch(
            kernel_pair, shape3, ops_stacked, v0s, m, lk)
        a_all = np.asarray(alphas)
        b_all = np.asarray(betas)
        for b in range(B):
            if done[b]:
                continue
            a, bb = a_all[b], b_all[b]
            k_eff = m
            tiny = max(1e-14, 10 * np.finfo(np.float64).eps) \
                * max(1.0, np.abs(a).max())
            for i in range(m - 1):
                if bb[i] < tiny:
                    k_eff = i + 1
                    break
            T = np.diag(a[:k_eff])
            if k_eff > 1:
                T += np.diag(bb[:k_eff - 1], 1) + np.diag(bb[:k_eff - 1], -1)
            tvals, tvecs = np.linalg.eigh(T)
            beta_last = bb[k_eff - 1] if k_eff <= m - 1 else bb[m - 1]
            want = nevs[b] - len(locked_vals[b])
            n_take = min(want, k_eff)
            resids = np.abs(beta_last * tvecs[-1, :n_take])
            Vb = _j_take_rows(_j_row(V, b), k_eff)
            ritz = _j_ritz(np.asarray(tvecs[:, :n_take].T, np.float64), Vb)
            scale = max(1.0, np.abs(tvals).max())
            newly = 0
            for j in range(n_take):
                if resids[j] < tol * scale \
                        or k_eff >= dim - len(locked_vals[b]):
                    vec = _j_row(ritz, j)
                    if locked_vecs[b]:
                        vec = _j_deflate(_j_stack(locked_vecs[b]), vec)
                    nrm = float(_j_norm(vec))
                    if nrm < 1e-10:
                        continue
                    locked_vecs[b].append(_j_scale(vec, nrm))
                    locked_vals[b].append(float(tvals[j]))
                    newly += 1
                else:
                    break
            if len(locked_vals[b]) >= nevs[b]:
                done[b] = True
                last_ritz[b] = None
                continue
            last_ritz[b] = (ritz, tvals[:n_take], newly)
            if newly < n_take:
                starts[b] = _j_row(ritz, newly)
            else:
                key2 = _jitted(jax.random.fold_in)(key, 1000 + restart * B + b)
                starts[b] = _j_randn_t(key2, dim, jnp.float64)
        if all(done):
            break
    out = []
    for b in range(B):
        # a lane that never fully converged: fill with DISTINCT unconverged
        # Ritz vectors from its last sweep (deflated against the locked
        # block) — duplicating the last locked pair would double-count one
        # physical state in the finite-T Boltzmann weights
        if len(locked_vals[b]) < nevs[b] and last_ritz[b] is not None:
            ritz_b, tvals_b, newly_b = last_ritz[b]
            for j in range(newly_b, ritz_b.shape[0]):
                if len(locked_vals[b]) >= nevs[b]:
                    break
                vec = _j_row(ritz_b, j)
                if locked_vecs[b]:
                    vec = _j_deflate(_j_stack(locked_vecs[b]), vec)
                nrm = float(_j_norm(vec))
                if nrm < 1e-10:
                    continue
                locked_vecs[b].append(_j_scale(vec, nrm))
                locked_vals[b].append(float(tvals_b[j]))
        if not locked_vals[b]:
            # zero states locked after max_restarts (pathological): solve
            # this lane through the serial fallback rather than crash
            vals, vecs = eigsh_lowest(
                mvs[b], dim, nevs[b], dtype=getattr(mvs[b], "dtype",
                                                    jnp.float64),
                m=m, tol=tol, max_restarts=max_restarts,
                refine_matvec=getattr(mvs[b], "exact", None))
            out.append((vals, vecs))
            continue
        order = np.argsort(locked_vals[b][:nevs[b]])
        vals = np.asarray(locked_vals[b])[order]
        vecs = _j_stack([locked_vecs[b][i] for i in order])
        exact = getattr(mvs[b], "exact", None)
        if exact is not None:
            pol_vals, pol_vecs = [], []
            for i in range(vecs.shape[0]):
                val, vec = _cluster_polish(exact, _j_row(vecs, i),
                                           pol_vecs, dim, sweep_op=mvs[b])
                pol_vals.append(val)
                pol_vecs.append(vec)
            order = np.argsort(pol_vals)
            vals = np.asarray(pol_vals)[order]
            vecs = _j_stack([pol_vecs[i] for i in order])
        out.append((vals, vecs))
    return out


def _cluster_polish(matvec, vec, deflate, dim, m_ref: int = 36,
                    max_rounds: int = 12, rtol: float = 1e-11,
                    max_cluster: int = 8, sweep_op=None, stats=None):
    """Polish one approximate eigenvector to f64 accuracy with exact
    matvecs, robust to near-degenerate clusters (see caller comment).

    Jacobi-Davidson-flavoured scheme: each round runs an m_ref-step Lanczos
    sweep from the current RESIDUAL and Rayleigh-Ritzes H over the FULL
    Krylov basis plus a carried block (current Ritz vector + cluster
    partners).  Two design points matter:

    * the whole Krylov basis enters the RR space — keeping only the sweep's
      lowest Ritz vectors would discard exactly the high-energy combination
      that forms the correction (H-theta)^-1 r, freezing the residual;
    * the carried block keeps the near-degenerate multiplet (e.g. 4 Hund
      states at gaps ~1e-4) in the basis, so the ground vector converges at
      the OUTER spectral gap (Davis-Kahan) instead of the inner one.

    The projection of H on the sweep basis is the Lanczos tridiagonal, so
    only the (<= max_cluster) block vectors cost extra matvecs per round.

    ``deflate``: already-polished lower eigenvectors to project out.

    ``sweep_op``: optional double-single pair operator (MixedKronMatvec /
    MixedJointKron).  When given, the m_ref-step expansion sweeps run on
    the fast DS matvec (f32 recurrence) until the exact residual stops
    halving — the RR extras block and the final Rayleigh quotients always
    use the exact ``matvec``, so converged values stay f64-accurate; only
    the *rate* of subspace expansion rides the DS kernel, finishing with
    exact sweeps only for the last ~1-2 rounds.

    Returns (value, vector)."""
    # the polish runs on the EXACT matvec: always carry 64-bit vectors even
    # when the sweep handed over a reduced-precision (huge-dim) Ritz vector
    if vec.dtype == jnp.float32:
        vec = _j_astype(vec, jnp.float64)
    elif vec.dtype == jnp.complex64:
        vec = _j_astype(vec, jnp.complex128)
    dtype = vec.dtype
    m_ref = min(m_ref, dim - 1) or 1
    # huge sectors: every exact matvec is costly — shrink the carried
    # cluster and keep exact sweeps short; the value-convergence
    # behaviour is unchanged, only the per-round exact-matvec budget
    huge = dim >= (1 << 22)
    if huge:
        max_cluster = min(max_cluster, 4)
    m_ref_exact = min(m_ref, 8) if huge else m_ref
    mvj = _jitted(matvec)
    block = [vec]
    hv0 = mvj(vec)
    val = float(_j_vdot_real(vec, hv0))
    rvec0 = _j_axpy(hv0, val, vec)
    resid0 = float(_j_norm(rvec0))
    # the input's exact residual is the baseline: a noisy round can never
    # make the returned pair worse than what came in (on near-degenerate
    # multiplets the DS-round Rayleigh-Ritz rotates O(1) inside the
    # multiplet — tridiag noise 1e-6·|H| over inner gaps ~1e-4)
    best = (resid0, val, vec)
    if resid0 < rtol * max(1.0, abs(val)):
        return val, vec
    # round 0 expands from the RESIDUAL direction (starting the sweep at
    # the eigenvector itself annihilates the carried block against the
    # Krylov basis and leaves a pure noisy-RR extraction)
    start = _j_scale(rvec0, resid0)
    ds_active = sweep_op is not None
    ds_rounds = 0
    prev_resid = resid0
    _last_val = [np.inf, 0]   # [last Rayleigh value, stagnant-round count]
    import os as _os
    import time as _time
    _pdbg = bool(_os.environ.get("EDTPU_DEBUG_POLISH"))
    for _round in range(max_rounds):
        _tr0 = _time.perf_counter()
        m_swp = m_ref if ds_active else m_ref_exact
        if stats is not None:
            stats["polish_rounds"] = stats.get("polish_rounds", 0) + 1
            if not ds_active:
                stats["polish_matvecs"] = stats.get("polish_matvecs", 0) \
                    + m_swp
            stats["polish_matvecs"] = stats.get("polish_matvecs", 0) + 1
        lk = (_j_stack(deflate) if deflate
              else _j_zeros((0, dim), dtype))
        if ds_active:
            a2, b2, V2 = lanczos_sweep_ds(sweep_op, start, m_swp, lk)
        else:
            a2, b2, V2 = lanczos_sweep(matvec, start, m_swp, lk)
        if _pdbg:
            _tp1 = _time.perf_counter()
        a2 = np.asarray(a2)
        b2 = np.asarray(b2)
        if _pdbg:
            print(f"[polish]   sweep {_tp1 - _tr0:.2f}s fetch "
                  f"{_time.perf_counter() - _tp1:.2f}s", flush=True)
            _tp1 = _time.perf_counter()
        k_eff = m_swp
        tiny = 1e-13 * max(1.0, np.abs(a2).max())
        for j in range(m_swp - 1):
            if b2[j] < tiny:
                k_eff = j + 1
                break
        t = np.diag(a2[:k_eff])
        if k_eff > 1:
            t += np.diag(b2[:k_eff - 1], 1) + np.diag(b2[:k_eff - 1], -1)
        Vd = _j_take_rows(V2, k_eff)                          # (k, dim)
        V2 = None   # free the (m+1, dim) sweep buffer (multi-GB at 1e7 dim)
        # FIXED-SHAPE extras block: always max_cluster rows (zero-padded).
        # A varying kb re-jits the stack/inner/combine helpers every round
        # — through a remote-compile transport that alone costs minutes per
        # ground state (the r04 843 s mystery); zero rows cost one wasted
        # batched matvec lane each and a pinned huge diagonal entry below.
        extras = []
        for u in block:
            if deflate:
                u = _j_deflate(_j_stack(deflate), u)
            for _ in range(2):
                u = _j_deflate(Vd, u)
                for e in extras:
                    u = _j_deflate_one(e, u)
            nrm = float(_j_norm(u))
            if nrm > 1e-7:
                extras.append(_j_scale(u, nrm))
        kb = len(extras)
        KB = max_cluster
        pad_rows = [_j_zeros((dim,), dtype)] * (KB - kb)
        n_rr = k_eff + KB
        cplx = jnp.issubdtype(dtype, jnp.complexfloating)
        hs = np.zeros((n_rr, n_rr), dtype=complex if cplx else float)
        hs[:k_eff, :k_eff] = t
        E = _j_stack(extras + pad_rows)                       # (KB, dim)
        # lax.map, not vmap: one launch with fixed shapes, but lanes run
        # sequentially so the exact-matvec temporaries peak at ONE lane —
        # a KB-wide vmapped f64 matvec holds KB full-sector temporaries at
        # once.  During DS rounds the extras products ride the DS matvec
        # too (the RR matrix is already at DS noise there) — exact rounds
        # and the final Rayleigh quotients below stay exact.
        if ds_active:
            def _ds64(u, _op=sweep_op):
                mhi, clo = _op.pair(u.astype(jnp.float32))
                return (mhi.astype(jnp.float64) + clo.astype(jnp.float64))
            HE = _jitted(lambda b: jax.lax.map(_ds64, b), owner=sweep_op,
                         attr="_edtpu_jit_map_ds")(E)
        else:
            HE = _jitted(lambda b: jax.lax.map(matvec, b), owner=matvec,
                         attr="_edtpu_jit_vmap")(E)
            if stats is not None:
                stats["polish_matvecs"] = stats.get("polish_matvecs", 0) + KB
        if _pdbg:
            print(f"[polish]   extras+HE {_time.perf_counter() - _tp1:.2f}s",
                  flush=True)
            _tp1 = _time.perf_counter()
        hs[:k_eff, k_eff:] = np.asarray(_j_inner(Vd, HE))
        hs[k_eff:, k_eff:] = np.asarray(_j_inner(E, HE))
        hs[k_eff:, :k_eff] = hs[:k_eff, k_eff:].conj().T
        if _pdbg:
            print(f"[polish]   inner {_time.perf_counter() - _tp1:.2f}s",
                  flush=True)
            _tp1 = _time.perf_counter()
        hs = 0.5 * (hs + hs.conj().T)
        # pin the zero-padded RR rows far above the spectrum so they can
        # never surface among the lowest eigenvectors
        pin = 10.0 * max(1.0, np.abs(hs).max())
        for j in range(kb, KB):
            hs[k_eff + j, :] = 0.0
            hs[:, k_eff + j] = 0.0
            hs[k_eff + j, k_eff + j] = pin
        sv, su = np.linalg.eigh(hs)
        nw = min(max_cluster, n_rr)
        cw = np.asarray(su[:, :nw].T, np.float64) if not cplx \
            else np.asarray(su[:, :nw].T)
        W = _j_combine2(np.ascontiguousarray(cw[:, :k_eff].real),
                        np.ascontiguousarray(cw[:, k_eff:].real), Vd, E) \
            if not cplx else _j_combine2c(cw[:, :k_eff], cw[:, k_eff:],
                                          Vd, E)
        w0 = _j_row(W, 0)
        vec = _j_scale(w0, float(_j_norm(w0)))
        if vec.dtype != dtype:
            # a DS-round Ritz vector is reduced precision; upcast BEFORE the
            # exact products — operator __call__s cast their output to the
            # input dtype, so feeding c64 would silently degrade the whole
            # exact refinement to c64 (the polish then floors at 1e-5)
            vec = _j_astype(vec, dtype)
        if _pdbg:
            print(f"[polish]   extract {_time.perf_counter() - _tp1:.2f}s",
                  flush=True)
            _tp1 = _time.perf_counter()
        hv = mvj(vec)
        val = float(_j_vdot_real(vec, hv))
        rvec = _j_axpy(hv, val, vec)
        resid = float(_j_norm(rvec))
        scale = max(1.0, abs(val))
        if _pdbg:
            print(f"[polish]   resid {_time.perf_counter() - _tp1:.2f}s",
                  flush=True)
        if _pdbg:
            print(f"[polish] round {_round} ds={ds_active} k_eff={k_eff} "
                  f"kb={kb} val={val:.12f} resid={resid:.3e} "
                  f"rr0={sv[0]:.12f} dt={_time.perf_counter() - _tr0:.2f}s",
                  flush=True)
        if resid < best[0]:
            best = (resid, val, vec)
        if resid < rtol * scale:
            break
        # value-stagnation stop: on huge sectors the residual floors at the
        # f32-stored-basis level (~1e-6·|H|) while the Rayleigh value has
        # long converged — two rounds without value motion end the polish
        if abs(val - _last_val[0]) <= max(1e-10, 10.0 * rtol) * scale:
            _last_val[1] += 1
            if _last_val[1] >= 2:
                break
        else:
            _last_val[1] = 0
        _last_val[0] = val
        ds_rounds += 1 if ds_active else 0
        if ds_active and (resid > 0.5 * prev_resid
                          or resid < 2e-5 * scale
                          or ds_rounds >= max_rounds // 2):
            # DS expansion stalled / approached the f32-pair noise floor /
            # used its round budget — finish on exact sweeps (val error
            # drops quadratically from here, reaching rtol in 1-3 rounds)
            ds_active = False
        prev_resid = resid
        block = [vec]
        for j in range(1, nw):
            if len(block) >= max_cluster:
                break
            wj = _j_row(W, j)
            if wj.dtype != dtype:
                wj = _j_astype(wj, dtype)
            block.append(_j_scale(wj, float(_j_norm(wj))))
        start = _j_scale(rvec, resid) if resid > 1e-14 * scale else vec
    bvec = best[2]
    if bvec.dtype == jnp.float32:
        bvec = _j_astype(bvec, jnp.float64)
    elif bvec.dtype == jnp.complex64:
        bvec = _j_astype(bvec, jnp.complex128)
    return best[1], bvec


@partial(jax.jit, static_argnums=(1,))
def _j_take_rows(a, k):
    return a[:k]


@jax.jit
def _j_inner(a, b):
    if a.dtype != b.dtype:
        # mixed basis/vector precision (DS polish rounds): contract at the
        # basis dtype in f64-accumulated chunks — a full promotion of the
        # (m, dim) basis to f64 costs multi-GB temps
        b32 = b.astype(a.dtype)
        k, n = a.shape
        c = 2048
        pad = (-n) % c
        if pad:
            a = jnp.concatenate([a, jnp.zeros((k, pad), a.dtype)], axis=1)
            b32 = jnp.concatenate(
                [b32, jnp.zeros((b32.shape[0], pad), b32.dtype)], axis=1)
        ap = jnp.conj(a).reshape(k, -1, c)
        bp = b32.reshape(b32.shape[0], -1, c)
        part = jnp.einsum("kct,mct->kmc", ap, bp,
                          precision=jax.lax.Precision.HIGHEST)
        acc = (jnp.complex128 if jnp.issubdtype(a.dtype, jnp.complexfloating)
               else jnp.float64)
        return part.astype(acc).sum(axis=-1)
    return jnp.matmul(jnp.conj(a), b.T,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _j_combine2(c1, c2, vd, e):
    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul(c1.astype(vd.dtype), vd, precision=hp) \
        + jnp.matmul(c2.astype(vd.dtype), e, precision=hp)


def _j_ritzc(c, vd):
    """complex host coefficients: ship real/imag planes separately."""
    return _j_ritzc_impl(np.ascontiguousarray(c.real),
                         np.ascontiguousarray(c.imag), vd)


@jax.jit
def _j_ritzc_impl(cr, ci, vd):
    return jnp.matmul((cr + 1j * ci).astype(vd.dtype), vd,
                      precision=jax.lax.Precision.HIGHEST)


def _j_combine2c(c1, c2, vd, e):
    return _j_combine2c_impl(np.ascontiguousarray(c1.real),
                             np.ascontiguousarray(c1.imag),
                             np.ascontiguousarray(c2.real),
                             np.ascontiguousarray(c2.imag), vd, e)


@jax.jit
def _j_combine2c_impl(c1r, c1i, c2r, c2i, vd, e):
    hp = jax.lax.Precision.HIGHEST
    return jnp.matmul((c1r + 1j * c1i).astype(vd.dtype), vd, precision=hp) \
        + jnp.matmul((c2r + 1j * c2i).astype(vd.dtype), e, precision=hp)


@jax.jit
def batched_eigh(mats):
    """Batched dense diagonalization of padded small-sector Hamiltonians —
    the batched form of the reference's one-at-a-time LAPACK path
    (ED_DIAG_NORMAL.f90:225-250)."""
    return jnp.linalg.eigh(mats)
