"""Sector sweep / spectrum determination.

Parity target: reference ED_DIAG.f90 + ED_DIAG_NORMAL.f90 (:76-296 sweep,
solver choice :119-252, post-diag trimming and adaptive neigen feedback
:382-519). Departures from the reference:

* small sectors are *batched*: all dims ≤ lanc_dim_threshold are padded into
  shape buckets and diagonalized with one batched `jnp.linalg.eigh` per
  bucket (the reference LAPACK path is one sector at a time on the master
  rank);
* large sectors run restarted deflated Lanczos with the jitted sector matvec;
* multiple impurity *sites* (real-space DMFT, reference E2I_MAIN.f90:253-296
  round-robins sites over MPI ranks) batch into the same buckets: the
  (site, sector) product is one data-parallel eigh sharded over the device
  mesh (`diagonalize_sites`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EDConfig
from ..sectors import Sector, SectorTable
from ..ops.lanczos import batched_eigh, eigsh_lowest
from .eigenspace import EigenState, StateList


@dataclass
class DiagResult:
    state_list: StateList
    evals_by_sector: Dict[int, np.ndarray]
    neigen_sector: np.ndarray
    zeta: float
    e0: float
    # finite-T annealing feedback (reference ed_post_diag
    # ED_DIAG_NORMAL.f90:489-517): the adapted total-state budget the NEXT
    # solve should request, and the per-sector retained-state histogram
    lanc_nstates_total: int = 0
    sector_histogram: Optional[np.ndarray] = None


def _pad_pow2_bucket(dim: int) -> int:
    """Bucket size: next power of two (bounded recompilation)."""
    b = 8
    while b < dim:
        b *= 2
    return b


def diagonalize_sites(cfg: EDConfig, table: SectorTable,
                      matvec_builders: Sequence[Callable[[Sector], object]],
                      dense_builders: Sequence[Callable[[Sector], np.ndarray]],
                      neigen_overrides: Optional[Sequence] = None,
                      sector_masks: Optional[Sequence] = None
                      ) -> List[DiagResult]:
    """Sweep all (site, sector) pairs; one DiagResult per site.

    All sites share the sector structure (``table``) and the solver knobs in
    ``cfg``; per-site physics (Hloc, bath, U) lives in the builders.  Small
    sectors from EVERY site are padded into shared shape buckets and solved
    by one batched eigh per bucket, sharded over the device mesh — the
    batched form of the reference's site-over-ranks round robin
    (E2I_MAIN.f90:253-296) fused with its sector loop
    (ED_DIAG_NORMAL.f90:225-250).

    ``matvec_builders[s](sec)``: device matvec callable with .dim/.dtype
    ``dense_builders[s](sec)``: dense sector H (dim <= lanc_dim_threshold)
    """
    nsites = len(dense_builders)
    nsec = len(table)
    neigen = np.full((nsites, nsec), cfg.lanc_nstates_sector, dtype=int)
    if neigen_overrides is not None:
        for s, ov in enumerate(neigen_overrides):
            if ov is not None:
                neigen[s, :] = np.asarray(ov, int)
    base_twin = table.twin_mask()
    twin_masks = []
    for s in range(nsites):
        m = base_twin.copy()
        if sector_masks is not None and sector_masks[s] is not None:
            m = m & np.asarray(sector_masks[s], bool)
        twin_masks.append(m)

    sls = [StateList(beta=cfg.beta) for _ in range(nsites)]
    evals_by_sector: List[Dict[int, np.ndarray]] = [{} for _ in range(nsites)]

    # ---- partition (site, sector) pairs by path ----------------------
    dense_items: List[Tuple[int, int]] = []
    lanc_items: List[Tuple[int, int]] = []
    for s in range(nsites):
        for i in range(nsec):
            if not twin_masks[s][i]:
                continue
            dim = table.get_dim(i)
            if dim == 0:
                continue
            if dim <= cfg.lanc_dim_threshold:
                dense_items.append((s, i))
            else:
                lanc_items.append((s, i))

    # ---- batched dense path ------------------------------------------
    buckets: Dict[int, List[Tuple[int, int]]] = {}
    for s, i in dense_items:
        b = _pad_pow2_bucket(table.get_dim(i))
        buckets.setdefault(b, []).append((s, i))
    for bsize, items in sorted(buckets.items()):
        if cfg.ed_verbose >= 4:
            # _DEBUG-level bucket-assembly tracing (reference -D_DEBUG,
            # ED_DIAG_NORMAL.f90 per-sector prints)
            print(f"[edipack_tpu:DEBUG] dense bucket pad={bsize}: "
                  f"{len(items)} (site, sector) items "
                  f"{[(s, i) for s, i in items[:12]]}"
                  f"{'...' if len(items) > 12 else ''}")
        # chunk very large batches to bound memory AND the host->device
        # transfer size (~64MB/chunk at c128; large single device_puts are
        # punishing on slow transports)
        max_batch = max(1, (1 << 22) // (bsize * bsize))
        for lo in range(0, len(items), max_batch):
            chunk = items[lo:lo + max_batch]
            mats = np.zeros((len(chunk), bsize, bsize))
            dims = []
            cplx = False
            for bi, (s, i) in enumerate(chunk):
                h = dense_builders[s](table.sector(i))
                d = h.shape[0]
                if sanitize_enabled(cfg) and not np.allclose(
                        h, np.conj(h.T), atol=1e-10 * (np.abs(h).max() + 1)):
                    raise AssertionError(
                        f"[ed_sanitize] sector {i} (site {s}): dense H is "
                        f"not Hermitian — term builder bug")
                dims.append(d)
                if np.iscomplexobj(h):
                    cplx = True
                mats = mats.astype(np.complex128) if cplx and not np.iscomplexobj(mats) else mats
                mats[bi, :d, :d] = h
                # push padding levels far above the physical spectrum
                pad = np.abs(h).sum() + 1.0
                mats[bi, d:, d:] = np.eye(bsize - d) * pad if bsize > d else 0.0
            hmats = jnp.asarray(mats)
            ndev = len(jax.devices())
            if ndev > 1 and len(chunk) > 1:
                # (site, sector)-level data parallelism: shard the batch over
                # every device (the 'sec' axis of SURVEY §2.4 — the
                # reference diagonalizes sectors serially on the master,
                # ED_DIAG_NORMAL.f90:225-250; here each chip eigh-solves its
                # own slice of the padded bucket)
                from jax.sharding import (Mesh, NamedSharding,
                                          PartitionSpec as P)
                nb = len(chunk)
                nsh = min(ndev, nb)
                pad_b = -(-nb // nsh) * nsh - nb
                if pad_b:
                    eye = jnp.eye(bsize, dtype=hmats.dtype)
                    hmats = jnp.concatenate(
                        [hmats, jnp.broadcast_to(eye, (pad_b, bsize, bsize))])
                bmesh = Mesh(np.array(jax.devices()[:nsh]), ("b",))
                hmats = jax.device_put(
                    hmats, NamedSharding(bmesh, P("b", None, None)))
            evals, evecs = batched_eigh(hmats)
            evals = np.asarray(evals)
            for bi, (s, i) in enumerate(chunk):
                d = dims[bi]
                ev = evals[bi, :d]
                evals_by_sector[s][i] = ev
                # keep at least the sector's full near-degenerate ground
                # multiplet so the T=0 trim can't miss degeneracies
                n_deg = int(np.sum(ev - ev[0] <= cfg.gs_threshold))
                keep = min(d, max(neigen[s, i], n_deg, 1))
                for j in range(keep):
                    vec = evecs[bi, :d, j]
                    sls[s].add(EigenState(float(ev[j]), i, vec))

    # ---- Lanczos path -------------------------------------------------
    # same-shape sectors (across sites AND particle-hole partners within a
    # site) run as ONE lockstep batched-DS-sweep launch instead of the
    # reference's strictly serial sector loop (ED_DIAG_NORMAL.f90:108;
    # SURVEY §2.4.1); fused/sharded operators keep per-sector launches.
    import time as _time
    sector_times: List[Tuple] = []
    groups: Dict[Tuple, List[Tuple[int, int, object]]] = {}
    singles: List[Tuple[int, int]] = []
    for s, i in lanc_items:
        mv = matvec_builders[s](table.sector(i))
        if (cfg.ed_batch_lanczos and type(mv).__name__ == "MixedKronMatvec"
                and getattr(mv, "_sharding", None) is None):
            # group key = shape3 AND the full ops pytree layout: two
            # same-dim sectors can carry structurally different operand
            # trees (e.g. nl_eb vs nl_a nonlocal terms, different term
            # counts), which jax.tree.map stacking would reject
            ops_sig = (jax.tree.structure(mv.ops),
                       tuple((np.shape(leaf), str(np.asarray(leaf).dtype)
                              if not hasattr(leaf, "dtype")
                              else str(leaf.dtype))
                             for leaf in jax.tree.leaves(mv.ops)))
            groups.setdefault((mv.shape3, ops_sig), []).append((s, i, mv))
        else:
            singles.append((s, i))
    for (shape3, _sig), items in groups.items():
        if len(items) < 2:
            singles.extend((s, i) for s, i, _ in items)
            continue
        if cfg.ed_verbose >= 4:
            print(f"[edipack_tpu:DEBUG] lockstep Lanczos batch "
                  f"shape={shape3}: {[(s, i) for s, i, _ in items]}")
        dim = int(np.prod(shape3))
        # bound the batched basis memory (B * (m+1) * dim f32)
        nev_max = max(min(max(int(neigen[s, i]), 1), dim - 1) or 1
                      for s, i, _ in items)
        m = min(dim, max(cfg.lanc_ncv_factor * nev_max + cfg.lanc_ncv_add,
                         4 * nev_max + 24, 48))
        max_b = max(2, int((1 << 31) // max(1, (m + 1) * dim * 4)))
        for lo in range(0, len(items), max_b):
            chunk = items[lo:lo + max_b]
            if len(chunk) == 1:
                singles.append(chunk[0][:2])
                continue
            _t0 = _time.perf_counter()
            from ..ops.lanczos import eigsh_lowest_batch
            nevs = [min(max(int(neigen[s, i]), 1), dim - 1) or 1
                    for s, i, _ in chunk]
            if sanitize_enabled(cfg):
                for s, i, mv in chunk:
                    _sanitize_mv(cfg, i, mv)
            res = eigsh_lowest_batch([mv for _, _, mv in chunk], nevs, m=m,
                                     tol=max(cfg.lanc_tolerance, 2e-6),
                                     max_restarts=max(4,
                                                      cfg.lanc_niter // m))
            for (s, i, _), (vals, vecs) in zip(chunk, res):
                if sanitize_enabled(cfg):
                    _sanitize_spectrum(i, vals)
                evals_by_sector[s][i] = vals
                for j in range(len(vals)):
                    sls[s].add(EigenState(float(vals[j]), i, vecs[j]))
            sector_times.append((chunk[0][1], dim,
                                 sum(len(v) for v, _ in res),
                                 _time.perf_counter() - _t0))
    for s, i in singles:
        _t0 = _time.perf_counter()
        _lanczos_solve_sector(cfg, table, i, matvec_builders[s],
                              neigen[s, i], sls[s], evals_by_sector[s])
        sector_times.append((i, table.get_dim(i),
                             len(evals_by_sector[s][i]),
                             _time.perf_counter() - _t0))
    if cfg.ed_verbose >= 3 and sector_times:
        # per-sector timing table (reference SF_TIMER eta prints per sector,
        # ED_DIAG_NORMAL.f90:101-154; here one summary table)
        print("[edipack_tpu] per-sector Lanczos timings:")
        for i, d, nv, dt in sorted(sector_times, key=lambda t: -t[3])[:20]:
            print(f"  sector {i:4d} dim {d:>10d} nev {nv}  {dt:8.3f}s")

    # ---- nonsu2 twin elision: re-solve elided sectors whose states the
    # trim will retain (reference ED_SETUP.f90:592-603 halves the nonsu2
    # scan; there is no basis-level signed permutation valid for arbitrary
    # baths, so retained twin VECTORS are obtained by an exact re-solve —
    # at T=0 the ground sector is self-twin and no re-solve happens)
    if cfg.ed_twin and cfg.ed_mode == "nonsu2":
        for s in range(nsites):
            _resolve_nonsu2_twins(cfg, table, sls[s], evals_by_sector[s],
                                  matvec_builders[s], dense_builders[s],
                                  neigen[s], twin_masks[s],
                                  sector_masks[s] if sector_masks else None)

    # ---- per-site tail: twins, trim, adaptive feedback ----------------
    out: List[DiagResult] = []
    for s in range(nsites):
        out.append(_finish_site(cfg, table, sls[s], evals_by_sector[s],
                                neigen[s], twin_masks[s], nsec))
    return out


def sanitize_enabled(cfg: EDConfig) -> bool:
    import os as _os
    return bool(cfg.ed_sanitize
                or _os.environ.get("EDIPACK_TPU_SANITIZE", "") not in ("", "0"))


def _sanitize_mv(cfg: EDConfig, i: int, mv) -> None:
    """Debug-build self-check of one sector operator (reference
    BUILD_TYPE=DEBUG runtime checking analog): verifies the device matvec
    is symmetric/Hermitian on a random pair — <u, Hv> == <Hu, v> — which
    catches term sign/layout bugs at the operator level before they
    surface as wrong physics.  Tolerance is set by the DS matvec noise
    floor (~3e-7 relative)."""
    rng = np.random.default_rng(1234 + i)
    dt = getattr(mv, "dtype", jnp.float64)
    cplx = jnp.issubdtype(dt, jnp.complexfloating)

    def rand_vec():
        x = rng.normal(size=mv.dim)
        if cplx:
            from ..ops.matvec import device_put_cplx
            v = device_put_cplx(x + 1j * rng.normal(size=mv.dim), dt)
        else:
            v = jax.device_put(jnp.asarray(x.astype(np.dtype(dt))))
        proj = getattr(mv, "v0_project", None)
        return jax.jit(proj)(v) if proj is not None else v

    u, v = rand_vec(), rand_vec()

    def body(op, u, v):
        hu, hv = op(u), op(v)
        s1 = jnp.vdot(u, hv)
        s2 = jnp.vdot(hu, v)
        scale = (jnp.linalg.norm(u) * jnp.linalg.norm(hv)
                 + jnp.linalg.norm(hu) * jnp.linalg.norm(v) + 1e-30)
        return jnp.abs(s1 - s2) / scale

    try:
        # registered-pytree operators ride as jit arguments (required on
        # transports that cannot embed device arrays as constants)
        defect = float(jax.jit(body)(mv, u, v))
    except TypeError:
        defect = float(jax.jit(lambda a, b: body(mv, a, b))(u, v))
    if not np.isfinite(defect) or defect > 5e-5:
        raise AssertionError(
            f"[ed_sanitize] sector {i}: matvec Hermiticity defect "
            f"{defect:.3e} (limit 5e-5) — operator term bug or NaN")


def _sanitize_spectrum(i: int, vals: np.ndarray) -> None:
    if not np.all(np.isfinite(np.asarray(vals))):
        raise AssertionError(
            f"[ed_sanitize] sector {i}: non-finite eigenvalues {vals}")


def _lanczos_solve_sector(cfg: EDConfig, table: SectorTable, i: int,
                          matvec_builder, nev_req: int, sl: StateList,
                          evals_by_sector: Dict[int, np.ndarray]) -> None:
    """Solve one Lanczos-sized sector into ``sl`` / ``evals_by_sector``."""
    sec = table.sector(i)
    mv = matvec_builder(sec)
    if sanitize_enabled(cfg):
        _sanitize_mv(cfg, i, mv)
    nev = min(max(nev_req, 1), mv.dim - 1) or 1
    m = min(mv.dim, max(cfg.lanc_ncv_factor * nev + cfg.lanc_ncv_add,
                        4 * nev + 24, 48))
    if cfg.lanc_method == "lanczos":
        # plain-Lanczos semantics (reference sp_lanc_eigh, T=0): one
        # long sweep sized by lanc_niter instead of the restarted
        # ARPACK-style NCV blocks
        m = min(mv.dim, max(m, min(cfg.lanc_niter, 512)))
    refine = getattr(mv, "exact", None)
    # mixed-precision matvec: residuals floor at the ~3e-7 matvec noise;
    # the exact f64 Rayleigh-Ritz refinement recovers the eigenvalues
    tol = max(cfg.lanc_tolerance, 1e-14) if refine is None \
        else max(cfg.lanc_tolerance, 2e-6)
    vals, vecs = eigsh_lowest(mv, mv.dim, nev, dtype=mv.dtype, m=m,
                              tol=tol,
                              max_restarts=max(4, cfg.lanc_niter // m),
                              refine_matvec=refine)
    if sanitize_enabled(cfg):
        _sanitize_spectrum(i, vals)
    evals_by_sector[i] = vals
    conv = getattr(mv, "from_internal_flat", None)
    for j in range(len(vals)):
        vec = conv(vecs[j]) if conv is not None else vecs[j]
        if refine is None and vec.dtype != mv.dtype:
            # unrefined huge sectors return their f32/c64 Krylov storage
            # precision (ops.lanczos.F32_BASIS_MIN_DIM); states enter the
            # list at the operator's dtype so GF chains stay in one dtype
            vec = vec.astype(mv.dtype)
        sl.add(EigenState(float(vals[j]), i, vec))


def _resolve_nonsu2_twins(cfg: EDConfig, table: SectorTable, sl: StateList,
                          evals_by_sector: Dict[int, np.ndarray],
                          matvec_builder, dense_builder, neigen: np.ndarray,
                          twin_mask: np.ndarray,
                          sector_mask: Optional[np.ndarray]) -> None:
    """Solve any twin-elided nonsu2 sector whose spectrum (mirrored from
    its solved partner) would enter the trimmed state list."""
    if len(sl) == 0:
        return
    # mirror partner energies into elided sectors (PH-symmetric spectra)
    cand = []
    for i in range(len(table)):
        if twin_mask[i] or table.get_dim(i) == 0:
            continue
        if sector_mask is not None and not sector_mask[i]:
            continue   # user-masked, not twin-elided
        j = table.twin_of(i)
        if j == i or j not in evals_by_sector:
            continue
        cand.append((i, evals_by_sector[j]))
    if not cand:
        return
    e0 = min(min(st.energy for st in sl),
             min(float(ev[0]) for _, ev in cand if len(ev)))
    for i, ev in cand:
        if len(ev) == 0:
            continue
        if cfg.ed_finite_temp:
            need = np.exp(-cfg.beta * (float(ev[0]) - e0)) > cfg.cutoff
        else:
            need = float(ev[0]) - e0 <= cfg.gs_threshold
        if not need:
            # energy bookkeeping only (evals getters, neigen annealing)
            evals_by_sector[i] = np.asarray(ev).copy()
            continue
        # exact re-solve (vectors required)
        if table.get_dim(i) <= cfg.lanc_dim_threshold:
            h = dense_builder(table.sector(i))
            evs, evecs = np.linalg.eigh(h)
            evals_by_sector[i] = evs
            n_deg = int(np.sum(evs - evs[0] <= cfg.gs_threshold))
            keep = min(len(evs), max(int(neigen[i]), n_deg, 1))
            for k in range(keep):
                sl.add(EigenState(float(evs[k]), i,
                                  jnp.asarray(evecs[:, k])))
        else:
            _lanczos_solve_sector(cfg, table, i, matvec_builder,
                                  int(neigen[i]), sl, evals_by_sector)


def _twin_state_joint(sec, sec_twin, vector):
    """superc twin eigenvector: Sz -> -Sz is the spin-swap relabeling of the
    joint basis, |up,dw> -> (-1)^{nup(nup-1)/2 + ndw(ndw-1)/2} |dw,up>
    (reference twin_sector_order + flip_state_other,
    ED_SECTOR.f90:1776-1816; the sign is the JW reordering of each spin
    block's internal string, verified against re-diagonalization over every
    Sz pair incl. pairing + interaction terms)."""
    from ..fock import popcount
    ns = sec.ns
    st = np.asarray(sec.states)
    mask = (np.int64(1) << np.int64(ns)) - 1
    nup = popcount(st & mask)
    ndw = popcount(st >> np.int64(ns))
    sign = (-1.0) ** ((nup * (nup - 1)) // 2 + (ndw * (ndw - 1)) // 2)
    flip = (st >> np.int64(ns)) | ((st & mask) << np.int64(ns))
    pos = np.searchsorted(np.asarray(sec_twin.states), flip)
    v = jnp.reshape(vector, (sec.dim_ph, sec.dim_el))
    w = jnp.zeros_like(v)
    w = w.at[:, pos].set(v * jnp.asarray(sign)[None, :].astype(v.dtype))
    return w.reshape(-1)


def _finish_site(cfg: EDConfig, table: SectorTable, sl: StateList,
                 evals_by_sector: Dict[int, np.ndarray], neigen: np.ndarray,
                 twin_mask: np.ndarray, nsec: int) -> DiagResult:
    if len(sl) == 0:
        raise RuntimeError("no eigenstates found (all sectors empty?)")

    # ---- twin reconstruction (reference twin_sector_order,
    # ED_SECTOR.f90:1747-1843). Normal mode: the twin (Ndw,Nup) state is the
    # transpose of V[ph, dw, up] (per-spin convention — spin-label swap).
    # superc: signed spin-swap permutation of the joint basis (see
    # _twin_state_joint). nonsu2 diagonalizes both twins (twin_mask).
    if cfg.ed_twin and cfg.ed_mode in ("normal", "superc"):
        for st in list(sl.states):
            j = table.twin_of(st.sector)
            if j != st.sector and not twin_mask[j]:
                sec = table.sector(st.sector)
                if cfg.ed_mode == "normal":
                    v3 = jnp.reshape(st.vector,
                                     (sec.dim_ph, sec.dim_dw, sec.dim_up))
                    vt = jnp.swapaxes(v3, 1, 2).reshape(-1)
                else:
                    vt = _twin_state_joint(sec, table.sector(j), st.vector)
                sl.add(EigenState(st.energy, j, vt, twin_of=st.sector))
                if st.sector in evals_by_sector:
                    evals_by_sector[j] = evals_by_sector[st.sector]

    # ---- trim + adaptive feedback (reference ed_post_diag,
    # ED_DIAG_NORMAL.f90:443-517) ---------------------------------------
    trimmed = sl.trim(cfg.ed_finite_temp, cfg.cutoff, cfg.gs_threshold,
                      cfg.lanc_nstates_total)
    counts = np.zeros(nsec, dtype=int)
    for st in trimmed:
        counts[st.sector] += 1
    new_neigen = neigen.copy()
    new_total = cfg.lanc_nstates_total
    if cfg.ed_finite_temp:
        # per-sector annealing: sectors present in the retained list get one
        # more requested state, absent ones one fewer; clamp to
        # [1, count + 1] (:475-487)
        for i in range(nsec):
            new_neigen[i] = neigen[i] + 1 if counts[i] > 0 else neigen[i] - 1
            new_neigen[i] = min(new_neigen[i], counts[i] + 1)
            new_neigen[i] = max(new_neigen[i], 1)
        # total-budget annealing (:489-517): if the Boltzmann weight of the
        # highest retained state is still above cutoff, the spectrum window
        # was too small -> grow the budget; otherwise settle it just above
        # the trimmed size
        sl.sort()
        e0_all, emax = sl.e0, sl.states[-1].energy
        if np.exp(-cfg.beta * (emax - e0_all)) > cfg.cutoff:
            new_total = cfg.lanc_nstates_total + cfg.lanc_nstates_step
        else:
            new_total = max(len(trimmed), cfg.lanc_nstates_step) \
                + cfg.lanc_nstates_step
    else:
        for i in range(nsec):
            if counts[i] >= neigen[i] and counts[i] > 0:
                new_neigen[i] = min(neigen[i] + cfg.lanc_nstates_step,
                                    max(table.get_dim(i), 1))
            elif counts[i] > 0:
                new_neigen[i] = max(counts[i] + 1, 1)

    e0 = trimmed.e0
    return DiagResult(trimmed, evals_by_sector, new_neigen,
                      trimmed.partition_function(), e0,
                      lanc_nstates_total=new_total,
                      sector_histogram=counts)


def diagonalize(cfg: EDConfig, table: SectorTable,
                matvec_builder: Callable[[Sector], object],
                dense_builder: Callable[[Sector], np.ndarray],
                neigen_override: Optional[np.ndarray] = None,
                sector_mask: Optional[np.ndarray] = None) -> DiagResult:
    """Single-site sweep: the one-site specialization of diagonalize_sites.

    ``matvec_builder(sec)``: device matvec callable with .dim/.dtype
    ``dense_builder(sec)``: dense sector H (used when dim <= lanc_dim_threshold)
    """
    return diagonalize_sites(cfg, table, [matvec_builder], [dense_builder],
                             neigen_overrides=[neigen_override],
                             sector_masks=[sector_mask])[0]
