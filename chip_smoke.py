#!/usr/bin/env python
"""End-to-end smoke run of the impurity solver on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: phases 1-5 below
    python chip_smoke.py --four    # four GPUs: the dw-sharded flagship
                                   # sector against one card, nothing else

Phases (each prints its wall time and the part of it spent tracing,
lowering and compiling):

1. device      JAX must report a GPU; no CPU fallback.
2. oracle      config 1 (Norb=1, Nbath=4, normal) plus one superc and one
               nonsu2 impurity through ed_init_solver / ed_set_hloc /
               ed_solve / ed_get_*, against the brute-force Fock-space
               oracle of tests/oracle.py on the host.
3. flagship    the largest sector (7,7) of config 2 (two-orbital Kanamori,
   matvec      Nbath=6, dim 3432^2): the production matvec on the GPU against
               KronMatvec.kernel on the host CPU backend.
4. flagship    production Lanczos on that sector, cold then warm.
   E0
5. full solve  ed_solve of config 2 at Nbath=6, GF on, with ed_twin=T:
               the reference's twin-sector option, exact for this
               spin-symmetric problem, solves one sector of each
               (Nup,Ndw)/(Ndw,Nup) pair.  Every sector compiles its own
               Lanczos programs, and a cold run of all 185 Lanczos sectors
               alone took 922 s on an H100, too long for one smoke run.

Any failed check raises, so the exit code is non-zero.  The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from edipack_tpu.bath.dmft_bath import init_bath  # noqa: E402
from edipack_tpu.config import default_config  # noqa: E402
from edipack_tpu.main import (ed_finalize_solver, ed_get_docc,  # noqa: E402
                              ed_get_dens, ed_get_gimp, ed_get_sigma,
                              ed_init_solver, ed_set_hloc, ed_solve)
from edipack_tpu.ops.matvec import KronMatvec  # noqa: E402
from edipack_tpu.sectors import SectorTable  # noqa: E402
from edipack_tpu.solver.core import _normal_builders  # noqa: E402
from edipack_tpu.umatrix import build_umatrix  # noqa: E402

# Config 2 of BASELINE.json: two-orbital Hubbard-Kanamori impurity with the
# reference's default bath size, Nbath=6 (Ns=14); largest sector (7,7).
FLAGSHIP = dict(norb=2, nbath=6, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
                jx=0.15, jp=0.15)
FLAGSHIP_SECTOR = (7, 7)
# Ground energy of sector (7,7) of FLAGSHIP with the default bath: the value
# this engine's earlier benchmark records give for the sector, where two
# eigensolver routes (double-single Lanczos + f64 polish, and f64 Lanczos)
# reproduced it to 1e-10.
E0_FLAGSHIP = -15.2060757903
E0_TOL = 1e-8
MATVEC_RTOL = 1e-12

# tolerances of the CPU tests for the same comparisons
# (tests/test_solve_normal.py, test_superc.py, test_nonsu2.py)
ORACLE_TOL = {"e0": 1e-10, "dens": 1e-8, "docc": 1e-8, "g": 1e-8}

# small cases the brute-force oracle handles (4^Ns Fock states);
# lanc_dim_threshold is lowered so the larger sectors run the Lanczos path
ORACLE_CASES = {
    "normal": dict(norb=1, nbath=4, nspin=1, uloc=[2.0], xmu=0.3,
                   lanc_dim_threshold=64),
    "superc": dict(norb=1, nbath=2, nspin=1, ed_mode="superc", uloc=[1.2],
                   xmu=0.1, deltasc=0.2, lanc_dim_threshold=8),
    "nonsu2": dict(norb=1, nbath=2, nspin=2, ed_mode="nonsu2", uloc=[1.4],
                   xmu=0.12, spin_field_x=[0.25], lanc_dim_threshold=8),
}

# ---------------------------------------------------------------------------
# compile accounting: trace + lower + backend-compile seconds, from JAX's
# monitoring events

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile = {"s": 0.0, "n": 0}


def _on_duration(event, duration_secs, **_kw):
    if event in _COMPILE_EVENTS:
        _compile["s"] += duration_secs
    if event == _COMPILE_EVENTS[-1]:
        _compile["n"] += 1


jax.monitoring.register_event_duration_secs_listener(_on_duration)


class phase:
    """Prints wall time and compile share of one phase; never swallows an
    exception."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"[phase] {self.name}: start", flush=True)
        self.t0 = time.perf_counter()
        self.c0 = dict(_compile)
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self.t0
        comp = _compile["s"] - self.c0["s"]
        ncomp = _compile["n"] - self.c0["n"]
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[phase] {self.name}: {status} wall {wall:.3f} s, compile "
              f"{comp:.3f} s ({ncomp} backend compiles)", flush=True)
        return False


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    """Card name and power limit, from a child process that does not use
    JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: oracle parity


def _oracle_hamiltonian(mode, cfg, hloc, um, bath):
    import oracle
    ns = (cfg.nbath + 1) * cfg.norb
    if mode == "normal":
        orc = oracle.FockOracle(ns, convention="per-spin")
        return orc, oracle.oracle_normal_hamiltonian(orc, cfg, hloc, um, bath)
    orc = oracle.FockOracle(ns, convention="joint")
    build = (oracle.oracle_superc_hamiltonian if mode == "superc"
             else oracle.oracle_nonsu2_hamiltonian)
    return orc, build(orc, cfg, hloc, um, bath)


def _lehmann(evals, evecs, gs, w, a, b, z):
    """<<A; B>>(z) averaged over the ground multiplet ``gs`` with weights
    ``w``: sum_n <g|A|n><n|B|g>/(z-(E_n-E_g)) + <g|B|n><n|A|g>/(z+(E_n-E_g))."""
    out = np.zeros(len(z), complex)
    for wg, g in zip(w, gs):
        psi = evecs[:, g]
        de = evals - evals[g]
        pa = psi.conj() @ (a @ evecs)           # <g|A|n>
        nb = evecs.conj().T @ (b @ psi)         # <n|B|g>
        pb = psi.conj() @ (b @ evecs)           # <g|B|n>
        na = evecs.conj().T @ (a @ psi)         # <n|A|g>
        out += wg * ((pa * nb)[None, :] / (z[:, None] - de[None, :])).sum(1)
        out += wg * ((pb * na)[None, :] / (z[:, None] + de[None, :])).sum(1)
    return out


def oracle_case(mode: str, device, nfreq: int = 8) -> dict:
    """Solve one small impurity through the public ed_* API on ``device``
    and compare E0, dens, docc and G(iw_n) with the oracle.  Returns the
    largest deviation of each quantity."""
    cfg = default_config(**ORACLE_CASES[mode])
    hloc = np.zeros((cfg.nspin, cfg.nspin, cfg.norb, cfg.norb))
    with jax.default_device(device):
        ed_init_solver(cfg=cfg)
        ed_set_hloc(hloc)
        res = ed_solve()
        z = 1j * (2 * np.arange(nfreq) + 1) * np.pi / cfg.beta
        g = ed_get_gimp(z)
        f = ed_get_gimp(z, typ="a") if mode == "superc" else None
        dens, docc = np.asarray(ed_get_dens()), np.asarray(ed_get_docc())
        e0 = float(res.e0)
        ed_finalize_solver()

    orc, h = _oracle_hamiltonian(mode, cfg, res.hloc, res.um, res.bath)
    evals, evecs = np.linalg.eigh(h.toarray())
    gs = np.nonzero(evals - evals[0] < 1e-8)[0]
    w = np.full(len(gs), 1.0 / len(gs))

    def expect(op):
        return sum(wg * (evecs[:, g].conj() @ (op @ evecs[:, g])).real
                   for wg, g in zip(w, gs))

    nu, nd = orc.n(0, 0), orc.n(0, 1)
    c = [orc.c(0, 0).toarray(), orc.c(0, 1).toarray()]
    err = {"e0": abs(e0 - evals[0]),
           "dens": abs(dens[0] - expect(nu + nd)),
           "docc": abs(docc[0] - expect(nu @ nd))}
    if mode == "nonsu2":
        err["g"] = max(np.abs(g[s1, s2, 0, 0] - _lehmann(
            evals, evecs, gs, w, c[s1], c[s2].conj().T, z)).max()
            for s1 in range(2) for s2 in range(2))
    else:
        err["g"] = np.abs(g[0, 0, 0, 0] - _lehmann(
            evals, evecs, gs, w, c[0], c[0].conj().T, z)).max()
    if f is not None:
        err["g"] = max(err["g"], np.abs(f[0, 0, 0, 0] - _lehmann(
            evals, evecs, gs, w, c[0], c[1], z)).max())
    return {k: float(v) for k, v in err.items()}


def phase_oracle(device) -> None:
    print(f"  tolerances: {ORACLE_TOL}")
    for mode in ORACLE_CASES:
        err = oracle_case(mode, device)
        print(f"  {mode}: " + ", ".join(f"|d{k}|={v:.2e}"
                                        for k, v in err.items()), flush=True)
        for k, v in err.items():
            check(v <= ORACLE_TOL[k],
                  f"oracle {mode}: |d{k}| = {v:.3e} > {ORACLE_TOL[k]}")


# ---------------------------------------------------------------------------
# phases 3-4: the flagship sector


def flagship(cfg_kw: dict = FLAGSHIP, sector=FLAGSHIP_SECTOR):
    """(cfg, table, builders, sector) of the production normal-mode solver;
    builders.matvec_builder is what ed_solve uses."""
    cfg = default_config(**cfg_kw)
    um = build_umatrix(cfg)
    bath = init_bath(cfg)
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    table = SectorTable(cfg)
    b = _normal_builders(cfg, table, hloc, um, bath)
    sec = table.by_qn(("n", (sector[0],), (sector[1],)))
    return cfg, table, b, sec


def random_vector(dim: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=dim)


def host_reference_matvec(op, v: np.ndarray) -> np.ndarray:
    """KronMatvec.kernel in f64 on the host CPU backend."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = KronMatvec(op, dtype=jnp.float64)
        v3 = jax.device_put(v.reshape(ref.shape3), cpu)
        return np.asarray(jax.jit(KronMatvec.kernel)(ref.ops, v3)).reshape(-1)


def rel_maxnorm(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_matvec(device, cfg_kw: dict = FLAGSHIP, sector=FLAGSHIP_SECTOR):
    with jax.default_device(device):
        cfg, table, b, sec = flagship(cfg_kw, sector)
        mv = b.matvec_builder(sec)
        v = random_vector(mv.dim)
        vd = jax.device_put(jnp.asarray(v))
        compiled = jax.jit(mv).lower(vd).compile()
        w = np.asarray(compiled(vd))
    print(f"  sector {sector}: dim {sec.dim} = {sec.dim_dw} x {sec.dim_up}, "
          f"operator {type(mv).__name__}")
    print(f"  memory_analysis: {compiled.memory_analysis()}")
    w_ref = host_reference_matvec(b.op_cache[sec.index], v)
    rel = rel_maxnorm(w, w_ref)
    print(f"  device vs host-CPU KronMatvec.kernel: max-norm rel diff "
          f"{rel:.3e} (limit {MATVEC_RTOL:g})")
    check(rel <= MATVEC_RTOL, f"flagship matvec rel diff {rel:.3e}")
    return rel


def sector_e0(cfg, table, b, sec) -> float:
    """Lowest eigenvalue of one sector through the production per-sector
    Lanczos driver (solver/diag.py)."""
    from edipack_tpu.solver.diag import _lanczos_solve_sector
    from edipack_tpu.solver.eigenspace import StateList
    evals = {}
    _lanczos_solve_sector(cfg, table, sec.index, b.matvec_builder,
                          cfg.lanc_nstates_sector, StateList(beta=cfg.beta),
                          evals)
    return float(evals[sec.index][0])


def phase_e0(device, cfg_kw: dict = FLAGSHIP, sector=FLAGSHIP_SECTOR,
             e0_ref: float = E0_FLAGSHIP):
    with jax.default_device(device):
        cfg, table, b, sec = flagship(cfg_kw, sector)
        out = []
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            e0 = sector_e0(cfg, table, b, sec)
            dt = time.perf_counter() - t0
            print(f"  {tag}: E0 = {e0:.10f} in {dt:.3f} s "
                  f"(|dE0| = {abs(e0 - e0_ref):.2e}, limit {E0_TOL:g})",
                  flush=True)
            check(abs(e0 - e0_ref) <= E0_TOL, f"{tag} E0 {e0!r}")
            out.append(e0)
    return out


# ---------------------------------------------------------------------------
# phase 5: full solve


def phase_solve(device, cfg_kw: dict = FLAGSHIP, twin: bool = True):
    cfg = default_config(**cfg_kw, ed_twin=twin)
    if twin:
        print("  ed_twin=T: the spin-symmetric problem solves one sector of "
              "each (Nup,Ndw)/(Ndw,Nup) pair (a cold solve of every sector "
              "does not fit one smoke run)")
    with jax.default_device(device):
        ed_init_solver(cfg=cfg)
        ed_set_hloc(np.zeros((1, 1, cfg.norb, cfg.norb)))
        res = ed_solve()
        g = ed_get_gimp()
        s = ed_get_sigma()
        dens, docc = ed_get_dens(), ed_get_docc()
        ed_finalize_solver()
    print(f"  timings: " + ", ".join(f"{k} {v:.3f} s"
                                    for k, v in res.timings.items()))
    print(f"  E0 {res.e0:.10f}  dens {np.round(dens, 8).tolist()}  "
          f"docc {np.round(docc, 8).tolist()}")
    print(f"  G {g.shape} finite: {bool(np.all(np.isfinite(g)))}, "
          f"Sigma {s.shape} finite: {bool(np.all(np.isfinite(s)))}")
    check(np.all(np.isfinite(g)) and np.all(np.isfinite(s)),
          "G or Sigma not finite")
    check(np.all(np.isfinite(dens)) and np.all(np.isfinite(docc)),
          "dens/docc not finite")
    stats = device.memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return res


# ---------------------------------------------------------------------------
# --four: the dw-sharded flagship sector


def _collectives(hlo: str):
    return [c for c in ("all-to-all", "all-gather", "all-reduce",
                        "collective-permute", "reduce-scatter") if c in hlo]


def _ms_per_matvec(fn, v, reps: int = 20) -> float:
    fn(v).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        w = fn(v)
    w.block_until_ready()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_four(devices, cfg_kw: dict = FLAGSHIP, sector=FLAGSHIP_SECTOR,
               e0_ref: float = E0_FLAGSHIP):
    """The production builder shards the dw axis of large sectors whenever
    it sees more than one device (solver/core.py); check that it really
    does, that the program communicates, and that it agrees with one card."""
    n = len(devices)
    cfg, table, b, sec = flagship(cfg_kw, sector)
    mv = b.matvec_builder(sec)
    check(getattr(mv, "_sharding", None) is not None,
          "production builder did not shard the flagship sector")
    print(f"  mesh {dict(mv._sharding.mesh.shape)} over {n} devices, "
          f"sector dim {sec.dim} = {sec.dim_dw} x {sec.dim_up}")
    for name in ("d", "hdw"):
        placed = {s.device for s in mv.ops[name].addressable_shards}
        print(f"  operand {name}: {mv.ops[name].sharding.spec} on "
              f"{len(placed)} devices")
    placed = {s.device for s in mv.ops["d"].addressable_shards}
    check(len(placed) == n, f"diagonal on {len(placed)} devices, not {n}")
    v = random_vector(mv.dim)
    vd = jax.device_put(jnp.asarray(v))
    fn = jax.jit(mv)
    compiled = fn.lower(vd).compile()
    colls = _collectives(compiled.as_text())
    print(f"  collectives in the compiled matvec: {colls}")
    check(bool(colls), "sharded matvec compiled to no collectives")
    w = np.asarray(compiled(vd))
    out_devs = {s.device for s in compiled(vd).addressable_shards}
    print(f"  output on {len(out_devs)} devices")

    with jax.default_device(devices[0]):
        ref = KronMatvec(b.op_cache[sec.index], dtype=jnp.float64)
        v0 = jax.device_put(jnp.asarray(v), devices[0])
        fn1 = jax.jit(ref)
        w_ref = np.asarray(fn1(v0))
    rel = rel_maxnorm(w, w_ref)
    print(f"  sharded vs one-card KronMatvec: max-norm rel diff {rel:.3e} "
          f"(limit {MATVEC_RTOL:g})")
    check(rel <= MATVEC_RTOL, f"sharded matvec rel diff {rel:.3e}")

    t1 = _ms_per_matvec(fn1, v0)
    tn = _ms_per_matvec(fn, vd)
    print(f"  per matvec: 1 card {t1:.3f} ms, {n} cards {tn:.3f} ms "
          f"(ratio {t1 / tn:.2f})")

    t0 = time.perf_counter()
    e0 = sector_e0(cfg, table, b, sec)
    print(f"  sharded E0 = {e0:.10f} in {time.perf_counter() - t0:.3f} s "
          f"(|dE0| = {abs(e0 - e0_ref):.2e}, limit {E0_TOL:g})")
    check(abs(e0 - e0_ref) <= E0_TOL, f"sharded E0 {e0!r}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded flagship phase")
    args = ap.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX reports {dev.platform!r}",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX reports {len(devices)}",
              file=sys.stderr)
        return 2

    from edipack_tpu.utils.jax_cache import enable_compile_cache
    with phase("1 device"):
        cache = enable_compile_cache()
        smi = nvidia_smi()
        print(f"  device_kind {dev.device_kind!r}, count {len(devices)}, "
              f"jax {jax.__version__}, compile cache {cache}")
        print(f"  nvidia-smi name, power.limit: {smi}")

    if args.four:
        with phase("four-GPU sharded flagship sector"):
            phase_four(devices[:4])
    else:
        with phase("2 oracle parity (normal, superc, nonsu2)"):
            phase_oracle(dev)
        with phase("3 flagship matvec (7,7)"):
            phase_matvec(dev)
        with phase("4 flagship ground state (7,7)"):
            phase_e0(dev)
        with phase("5 full-width ed_solve, config 2"):
            phase_solve(dev)

    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
