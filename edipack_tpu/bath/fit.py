"""χ² bath fitting.

Parity target: reference ED_FIT/ (ED_BATH_FIT.f90:29-55 interface;
per-(bath_type×ed_mode) χ² and gradients, e.g. ED_FIT_NORMAL.f90:709-761).
Redesign: the Anderson function Δ(iω;p) / G0(iω;p) is written in
JAX over the *packed bath vector*, the gradient is exact via autodiff
(replacing the reference's hand-coded analytic gradients), and the
minimization uses scipy L-BFGS-B/CG on the host (the χ² is tiny).

Fit targets (cg_scheme): 'delta' fits Δ(iω), 'weiss' fits G0and(iω).
Weights (cg_weight): 1, 1/n, or 1/ω_n; power cg_pow; first cfg.lfit
Matsubara frequencies.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.optimize

from ..config import EDConfig
from .dmft_bath import array_to_bath, bath_to_array, get_bath_dimension
from .replica import ReplicaBasis


# ---------------------------------------------------------------------------
# jax Anderson functions from the packed bath vector (normal mode)
# ---------------------------------------------------------------------------


def _unpack_normal(p, cfg: EDConfig):
    """packed (normal/hybrid, ed_mode normal) -> (e, v) arrays."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        e = p[: ns * no * nb].reshape(ns, no, nb)
        v = p[ns * no * nb: 2 * ns * no * nb].reshape(ns, no, nb)
    else:  # hybrid
        e = p[: ns * nb].reshape(ns, 1, nb)
        v = p[ns * nb: ns * nb + ns * no * nb].reshape(ns, no, nb)
    return e, v


def _delta_normal_jax(p, z, cfg: EDConfig, ispin: int):
    """Δ^s_ab(z): (Norb, Norb, Lz) for the requested spin."""
    e, v = _unpack_normal(p, cfg)
    if cfg.bath_type == "normal":
        # diagonal: Σ_k v²/(z - e)
        d = jnp.sum(v[ispin, :, :, None] ** 2
                    / (z[None, None, :] - e[ispin, :, :, None]), axis=1)
        return jnp.einsum("al,ab->abl", d, jnp.eye(cfg.norb))
    return jnp.sum(v[ispin, :, None, :, None] * v[ispin, None, :, :, None]
                   / (z[None, None, None, :] - e[ispin, 0, None, None, :, None]),
                   axis=2)


def _delta_replica_jax(p, z, cfg: EDConfig, basis: ReplicaBasis, ispin: int):
    """Replica/general Δ^s(z) via (Norb,Norb) inversion per z per replica."""
    nb, no, ns = cfg.nbath, cfg.norb, cfg.nspin
    nsym = basis.nsym
    ops = jnp.asarray(np.real(basis.ops[:, ispin, ispin]))  # (Nsym,No,No)
    pos = 1
    out = jnp.zeros((no, no, z.shape[0]), dtype=z.dtype)
    for k in range(nb):
        if cfg.bath_type == "replica":
            vk = p[pos] * jnp.ones(no)
            pos += 1
        else:
            vk = p[pos: pos + ns * no].reshape(ns, no)[ispin]
            pos += ns * no
        lam = p[pos: pos + nsym]
        pos += nsym
        hk = jnp.einsum("s,sab->ab", lam, ops)
        zi = z[:, None, None] * jnp.eye(no)[None] - hk[None]
        g = jnp.linalg.inv(zi)  # (Lz, No, No)
        out = out + jnp.einsum("a,lab,b->abl", vk, g, vk)
    return out


def _weiss_from_delta(delta, z, hloc_s, cfg: EDConfig):
    """G0(z) = [(z+μ) - Hloc - Δ(z)]⁻¹ per frequency (Norb matrix)."""
    no = cfg.norb
    m = (z[:, None, None] + cfg.xmu) * jnp.eye(no)[None] \
        - hloc_s[None] - jnp.moveaxis(delta, -1, 0)
    return jnp.moveaxis(jnp.linalg.inv(m), 0, -1)


def _unpack_superc(p, cfg: EDConfig):
    """packed superc bath -> (e, d, v)."""
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        n = ns * no * nb
        return (p[:n].reshape(ns, no, nb), p[n:2 * n].reshape(ns, no, nb),
                p[2 * n:3 * n].reshape(ns, no, nb))
    ne = ns * nb
    return (p[:ne].reshape(ns, 1, nb), p[ne:2 * ne].reshape(ns, 1, nb),
            p[2 * ne:2 * ne + ns * no * nb].reshape(ns, no, nb))


def _delta_superc_jax(p, z, cfg: EDConfig):
    """(Δ, FΔ) on the Matsubara-like grid (reference delta/fdelta_normal
    superc branches): Δ = -Σ v²(z+e)/(|Im z|²+e²+d²), FΔ = Σ v²d/(...)."""
    e, d, v = _unpack_superc(p, cfg)
    den_z = jnp.imag(z) ** 2
    if cfg.bath_type == "normal":
        den = den_z[None, None, :] + (e[0, :, :, None] ** 2 + d[0, :, :, None] ** 2)
        dd = -jnp.sum(v[0, :, :, None] ** 2 * (z[None, None, :] + e[0, :, :, None])
                      / den, axis=1)
        fd = jnp.sum(v[0, :, :, None] ** 2 * d[0, :, :, None] / den, axis=1)
        eye = jnp.eye(cfg.norb)
        return (jnp.einsum("al,ab->abl", dd, eye),
                jnp.einsum("al,ab->abl", fd, eye))
    den = den_z[None, :] + e[0, 0, :, None] ** 2 + d[0, 0, :, None] ** 2
    vv = v[0, :, None, :, None] * v[0, None, :, :, None]     # (No,No,Nb,L)
    dd = -jnp.sum(vv * (z[None, None, None, :] + e[0, 0, None, None, :, None])
                  / den[None, None], axis=2)
    fd = jnp.sum(vv * d[0, 0, None, None, :, None] / den[None, None], axis=2)
    return dd, fd


def _replica_items(p, cfg: EDConfig, basis: ReplicaBasis):
    """Iterate the packed replica/general bath: yields (vk (Nspin*Norb,),
    lam (Nsym,)) per replica, skipping the leading Nsym slot."""
    nb, no, ns = cfg.nbath, cfg.norb, cfg.nspin
    nsym = basis.nsym
    pos = 1
    for k in range(nb):
        if cfg.bath_type == "replica":
            vk = p[pos] * jnp.ones(ns * no)
            pos += 1
        else:
            vk = p[pos: pos + ns * no]
            pos += ns * no
        lam = p[pos: pos + nsym]
        pos += nsym
        yield vk, lam


def _delta_replica_superc_jax(p, z, cfg: EDConfig, basis: ReplicaBasis):
    """Replica/general superc (Δ, FΔ) via the Nambu 2Norb×2Norb replica
    inversion (bath.functions._delta_replica_superc, jax/autodiff form)."""
    no = cfg.norb
    ops = jnp.asarray(basis.ops)               # (Nsym, 2, 2, No, No) Nambu
    dd = jnp.zeros((no, no, z.shape[0]), dtype=z.dtype)
    fd = jnp.zeros_like(dd)
    eye2 = jnp.eye(2 * no)
    for vk, lam in _replica_items(p, cfg, basis):
        hk = jnp.einsum("s,sab->ab", lam, ops[:, 0, 0])
        dk = jnp.einsum("s,sab->ab", lam, ops[:, 0, 1])
        hnam = jnp.block([[hk, dk], [jnp.conj(dk.T), -hk.T]])
        vnam = jnp.concatenate([vk[:no], -vk[:no]])
        g = jnp.linalg.inv(z[:, None, None] * eye2[None] - hnam[None])
        d = vnam[None, :, None] * g * vnam[None, None, :]
        dd = dd + jnp.moveaxis(d[:, :no, :no], 0, -1)
        fd = fd + jnp.moveaxis(d[:, :no, no:], 0, -1)
    return dd, fd


def _delta_replica_nonsu2_jax(p, z, cfg: EDConfig, basis: ReplicaBasis):
    """Replica/general nonsu2 Δ^{ss'}(z) = Σ_k V (z - H_k)⁻¹ V with the full
    spin-space replica Hamiltonians (bath.functions.delta_bath replica)."""
    ns, no = cfg.nspin, cfg.norb
    nso = ns * no
    ops = jnp.asarray(basis.ops)               # (Nsym, ns, ns, No, No)
    out = jnp.zeros((ns, ns, no, no, z.shape[0]), dtype=z.dtype)
    eye = jnp.eye(nso)
    for vk, lam in _replica_items(p, cfg, basis):
        hk = jnp.einsum("s,sij->ij", lam,
                        ops.transpose(0, 1, 3, 2, 4).reshape(-1, nso, nso))
        g = jnp.linalg.inv(z[:, None, None] * eye[None] - hk[None])
        d = vk[None, :, None] * g * vk[None, None, :]
        out = out + jnp.moveaxis(
            d.reshape(-1, ns, no, ns, no), 0, -1).transpose(0, 2, 1, 3, 4)
    return out


def _unpack_nonsu2(p, cfg: EDConfig):
    ns, no, nb = cfg.nspin, cfg.norb, cfg.nbath
    if cfg.bath_type == "normal":
        n = ns * no * nb
        return (p[:n].reshape(ns, no, nb), p[n:2 * n].reshape(ns, no, nb),
                p[2 * n:3 * n].reshape(ns, no, nb))
    ne = ns * nb
    nv = ns * no * nb
    return (p[:ne].reshape(ns, 1, nb), p[ne:ne + nv].reshape(ns, no, nb),
            p[ne + nv:ne + 2 * nv].reshape(ns, no, nb))


def _delta_nonsu2_jax(p, z, cfg: EDConfig):
    """Δ^{ss'}_ab(z) with spin-flip amplitudes (reference delta_normal nonsu2
    branch: W(s,h)=v if h==s else u; Δ^{ss'} = Σ_h W(s,h)W(s',h)/(z-e_h))."""
    e, v, u = _unpack_nonsu2(p, cfg)
    ns, no = cfg.nspin, cfg.norb
    w = jnp.stack([jnp.stack([v[0], u[0]]),
                   jnp.stack([u[ns - 1], v[ns - 1]])])  # (s, h, No, Nb)
    if cfg.bath_type == "normal":
        eh = jnp.stack([e[0], e[ns - 1]])               # (h, No, Nb)
        dd = jnp.einsum("shak,thak,hakl->stal",
                        w, w, 1.0 / (z[None, None, None, :] - eh[..., None]))
        eye = jnp.eye(no)
        return jnp.einsum("stal,ab->stabl", dd, eye)
    eh = jnp.stack([e[0, 0], e[ns - 1, 0]])             # (h, Nb)
    return jnp.einsum("shak,thbk,hkl->stabl",
                      w, w, 1.0 / (z[None, None, :] - eh[..., None]))


def chi2_fitgf(cfg: EDConfig, func: np.ndarray, bath_array: np.ndarray,
               ispin: int = 1, iorb: Optional[int] = None,
               basis: Optional[ReplicaBasis] = None,
               hloc: Optional[np.ndarray] = None) -> np.ndarray:
    """Fit the bath to ``func`` = Weiss field or Δ on Matsubara frequencies.

    ``func``: (Norb,Norb,Lmats) or (Nspin,Nspin,Norb,Norb,Lmats); returns the
    updated packed bath array (reference overwrites the user bath)."""
    s = ispin - 1
    if not isinstance(func, (tuple, list)):
        func = np.asarray(func)
        if cfg.ed_mode == "normal":
            if func.ndim == 5:
                func = func[s, s]
            elif func.ndim == 1:
                func = func[None, None, :]
    nfit = min(cfg.lfit, (func[0] if isinstance(func, (tuple, list))
                          else func).shape[-1])
    if not isinstance(func, (tuple, list)):
        target = jnp.asarray(func[..., :nfit])  # overridden per mode below
    wn = (2 * np.arange(nfit) + 1) * np.pi / cfg.beta
    z = jnp.asarray(1j * wn)
    if cfg.cg_weight == 1:
        wts = np.ones(nfit)
    elif cfg.cg_weight == 2:
        wts = 1.0 / np.arange(1, nfit + 1)
    else:
        wts = 1.0 / wn
    wts = jnp.asarray(wts)

    if hloc is None:
        hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    hloc_s = jnp.asarray(np.real(hloc[s, s]))

    is_replica = cfg.bath_type in ("replica", "general")
    mode = cfg.ed_mode

    p_full = jnp.asarray(np.asarray(bath_array, float))
    diag_only = (cfg.bath_type == "normal")
    no = cfg.norb

    def reduce_chi2(diff):
        """cg_norm reduction (reference ED_FIT_*: 'elemental' sums
        |diff_ab|^pow per component; 'frobenius' takes the per-frequency
        matrix Frobenius norm^pow, chi2_delta_general_frobenius)."""
        if cfg.cg_norm == "frobenius":
            fro = jnp.sqrt(jnp.sum(jnp.abs(diff) ** 2,
                                   axis=tuple(range(diff.ndim - 1))))
            return jnp.sum(wts * fro ** cfg.cg_pow) / nfit \
                / (cfg.nspin * cfg.norb)
        return jnp.sum(wts * jnp.abs(diff) ** cfg.cg_pow) / nfit

    if is_replica:
        fit_idx = np.arange(1, p_full.shape[0])
    elif mode == "normal":
        ns, nb = cfg.nspin, cfg.nbath
        if cfg.bath_type == "normal":
            if iorb is not None:
                # single-orbital component fit (reference
                # ED_BATH_FIT.f90:112-113): only orbital iorb's (e, v) move
                io = iorb - 1
                idx_e = s * no * nb + io * nb + np.arange(nb)
                idx_v = ns * no * nb + s * no * nb + io * nb + np.arange(nb)
            else:
                idx_e = (np.arange(no * nb) + s * no * nb)
                idx_v = ns * no * nb + s * no * nb + np.arange(no * nb)
        else:
            idx_e = s * nb + np.arange(nb)
            idx_v = ns * nb + s * no * nb + np.arange(no * nb)
        fit_idx = np.concatenate([idx_e, idx_v])
    else:
        fit_idx = np.arange(p_full.shape[0])
    fit_idx = jnp.asarray(fit_idx, jnp.int32)

    if mode == "superc":
        # target: (2, Norb, Norb, L) stacked (normal, anomalous) parts, or a
        # tuple of the two (reference fits G0&F0 / Δ&FΔ jointly)
        if isinstance(func, (tuple, list)):
            tg = np.stack([np.asarray(func[0]), np.asarray(func[1])])
        else:
            tg = np.asarray(func)
        if tg.ndim == 6:   # (2, Nspin, Nspin, No, No, L)
            tg = tg[:, 0, 0]
        target = jnp.asarray(tg[..., :nfit])

        def model(p_fit):
            p = p_full.at[fit_idx].set(p_fit)
            if is_replica:
                dd, fd = _delta_replica_superc_jax(p, z, cfg, basis)
            else:
                dd, fd = _delta_superc_jax(p, z, cfg)
            if cfg.cg_scheme != "weiss":
                return jnp.stack([dd, fd])
            a11 = (z[:, None, None] + cfg.xmu) * jnp.eye(no)[None] \
                - hloc_s[None] - jnp.moveaxis(dd, -1, 0)
            a12 = -jnp.moveaxis(fd, -1, 0)
            m = jnp.block([[a11, a12],
                           [jnp.conj(jnp.swapaxes(a12, 1, 2)), -jnp.conj(a11)]])
            gi = jnp.linalg.inv(m)
            g0 = jnp.moveaxis(gi[:, :no, :no], 0, -1)
            f0 = jnp.moveaxis(gi[:, :no, no:], 0, -1)
            return jnp.stack([g0, f0])

        def chi2(p_fit):
            diff = model(p_fit) - target
            if diag_only:
                diff = diff * jnp.eye(no)[None, :, :, None]
            return reduce_chi2(diff)

    elif mode == "nonsu2":
        tg = np.asarray(func)   # (Nspin,Nspin,No,No,L)
        target = jnp.asarray(tg[..., :nfit])
        hloc_full = jnp.asarray(np.asarray(hloc, complex))

        def model(p_fit):
            p = p_full.at[fit_idx].set(p_fit)
            if is_replica:
                dd = _delta_replica_nonsu2_jax(p, z, cfg, basis)
            else:
                dd = _delta_nonsu2_jax(p, z, cfg)  # (s,s',a,b,L)
            if cfg.cg_scheme != "weiss":
                return dd
            ns_ = cfg.nspin
            nso = ns_ * no
            hmat = hloc_full.transpose(0, 2, 1, 3).reshape(nso, nso)
            dmat = jnp.moveaxis(dd, -1, 0).transpose(0, 1, 3, 2, 4) \
                .reshape(-1, nso, nso)
            m = (z[:, None, None] + cfg.xmu) * jnp.eye(nso)[None] \
                - hmat[None] - dmat
            gi = jnp.linalg.inv(m)
            return gi.reshape(-1, ns_, no, ns_, no).transpose(1, 3, 2, 4, 0)

        def chi2(p_fit):
            diff = model(p_fit) - target
            if diag_only:
                diff = diff * jnp.eye(no)[None, None, :, :, None]
            return reduce_chi2(diff)

    else:
        if is_replica:
            def delta_fn(p):
                return _delta_replica_jax(p, z, cfg, basis, s)
        else:
            def delta_fn(p):
                return _delta_normal_jax(p, z, cfg, s)

        def model(p_fit):
            p = p_full.at[fit_idx].set(p_fit)
            d = delta_fn(p)
            if cfg.cg_scheme == "weiss":
                return _weiss_from_delta(d, z, hloc_s, cfg)
            return d

        def chi2(p_fit):
            f = model(p_fit)
            diff = f - target
            if diag_only:
                diff = diff * jnp.eye(cfg.norb)[:, :, None]
            if iorb is not None:
                io = iorb - 1
                mask = jnp.zeros((no, no)).at[io, io].set(1.0)
                diff = diff * mask[:, :, None]
            return reduce_chi2(diff)

    # The chi^2 objective is tiny-tensor work (norb^2 x Lfit) driven by a
    # host-side scipy optimizer that fetches a scalar every iteration: pin
    # it to the host CPU backend.  On an accelerator default backend each
    # of the O(cg_niter x restarts) iterations would pay a device
    # round-trip for work the
    # host does in microseconds; the reference likewise fits on the host
    # (ED_FIT_COMMON chi2 + fmin_cg).
    try:
        _fit_dev = jax.local_devices(backend="cpu")[0]
    except RuntimeError:  # pragma: no cover - cpu backend always exists
        _fit_dev = None

    import contextlib
    _on_cpu = (jax.default_device(_fit_dev) if _fit_dev is not None
               else contextlib.nullcontext())
    with _on_cpu:
        val_grad = jax.jit(jax.value_and_grad(chi2))

    def fun(x):
        with _on_cpu:
            v, g = val_grad(jnp.asarray(x))
            return float(v), np.asarray(g, dtype=float)

    x0 = np.asarray(p_full)[np.asarray(fit_idx)]
    # cg_method 0 -> CG (reference fmin_cg); 1 -> the "minimize" backend,
    # where cg_minimize_ver picks the older Krauth-style quasi-Newton (BFGS,
    # dense Hessian as the older routine builds) vs the newer
    # limited-memory variant (reference ED_INPUT_VARS.f90:744)
    if cfg.cg_method == 0:
        method = "CG"
    else:
        method = "BFGS" if cfg.cg_minimize_ver else "L-BFGS-B"
    if method == "CG":
        opts = {"maxiter": cfg.cg_niter, "gtol": cfg.cg_ftol * 1e-2}
    elif method == "BFGS":
        opts = {"maxiter": cfg.cg_niter, "gtol": cfg.cg_ftol * 1e-2}
    else:
        # cg_stop (reference ED_FIT_COMMON stopping conditions): 0 = both
        # C1 (function change) and C2 (argument change), 1 = C1 only,
        # 2 = C2 only — mapped onto scipy L-BFGS-B's ftol/gtol pair
        opts = {"maxiter": cfg.cg_niter}
        if cfg.cg_stop in (0, 1):
            opts["ftol"] = cfg.cg_ftol
        if cfg.cg_stop in (0, 2):
            opts["gtol"] = cfg.cg_ftol * 1e-2
        if cfg.cg_stop == 2:
            opts["ftol"] = 1e-30   # disable C1, stop on gradient/step only

    # multi-start: the chi^2 landscape has spurious basins (a bath pole
    # escaping to large |e| with v->0); a few perturbed restarts recover the
    # global basin. The first start is always the caller's bath (warm start
    # across DMFT iterations).
    rng = np.random.default_rng(12345)
    starts = [x0]
    for _ in range(4):
        starts.append(x0 + rng.normal(scale=0.3, size=x0.shape)
                      * np.maximum(1.0, np.abs(x0)))
    best = None
    for xs in starts:
        res = scipy.optimize.minimize(fun, xs, jac=True, method=method,
                                      options=opts)
        if best is None or res.fun < best.fun:
            best = res
        if best.fun < 1e-12:
            break
    out = np.array(p_full)
    out[np.asarray(fit_idx)] = best.x
    return out
