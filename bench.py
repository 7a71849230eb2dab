#!/usr/bin/env python
"""Matvec rates and time to ground state on one GPU.

    python bench.py                      # every section
    python bench.py --section normal     # one of: normal superc nonsu2
                                         #         phonon gs

Sections (one process, one device; a missing GPU is an error):

* normal  the largest sector (7,7) of config 2 (two-orbital Kanamori,
          Nbath=6, dim 3432^2): the three f64-accurate matvecs —
          KronMatvec f64 (dense factor matmuls), ExactKronMatvec (ELL
          gathers) and MixedKronMatvec (double-single f32) — with their
          error against KronMatvec f64.
* superc  config 3 at reference scale (Norb=2, Nbath=5, Sz=0 sector,
          dim C(24,12)): padded-ELL JointMatvec c128 against blocked-Kron
          c128.
* nonsu2  config 4 at the same scale (Ntot=12 sector with SOC blocks and an
          in-plane field): the same two operators.
* phonon  config 5 (three orbitals + phonons): the production matvec.
* gs      time to ground state of sector (7,7) through the production
          builder and per-sector Lanczos driver, cold and warm.

"nnz" counts the nonzeros of the equivalent sparse sector Hamiltonian.
Every timing ends in block_until_ready.  Every record names the platform,
device kind, device count and the card's power limit.  The last line of
standard output is one JSON object with all records.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SECTIONS = ("normal", "superc", "nonsu2", "phonon", "gs")


def power_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def as_jit_args(mv):
    """(operands, apply): the operator's device arrays as a pytree, and
    apply(operands, v) == mv(v) with those arrays as jit ARGUMENTS rather
    than constants folded into the compiled program (which makes XLA's
    compile of a multi-GB operator slow)."""
    import copy
    import jax
    if jax.tree.leaves(mv) != [mv]:              # registered pytree
        return mv, lambda op, u: op(u)

    def all_arrays(x):
        leaves = jax.tree.leaves(x)
        return bool(leaves) and all(isinstance(l, jax.Array) for l in leaves)
    operands = {k: x for k, x in vars(mv).items() if all_arrays(x)}

    def apply(ops, u):
        m2 = copy.copy(mv)
        vars(m2).update(ops)
        return m2(u)
    return operands, apply


def time_matvec(mv, v, reps: int = 20) -> float:
    """Seconds per application of ``mv`` to ``v`` (warm, jitted)."""
    import jax
    ops, apply = as_jit_args(mv)
    fn = jax.jit(apply)
    fn(ops, v).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        w = fn(ops, v)
    w.block_until_ready()
    return (time.perf_counter() - t0) / reps


def apply_once(mv, v):
    import jax
    ops, apply = as_jit_args(mv)
    return jax.jit(apply)(ops, v)


def _rate(name, mv, v, rec, reps=20):
    dt = time_matvec(mv, v, reps)
    rec[f"{name}_ms"] = dt * 1e3
    rec[f"{name}_nnz_per_s"] = mv.nnz / dt
    log(f"{name}: {dt * 1e3:.3f} ms/matvec "
        f"({mv.nnz / dt / 1e9:.3f} Gnnz/s, dim {mv.dim}, nnz {mv.nnz})")
    return dt


def _flagship():
    from chip_smoke import flagship
    return flagship()


def bench_normal(rec):
    import jax
    import jax.numpy as jnp
    from edipack_tpu.ops.matvec import (ExactKronMatvec, KronMatvec,
                                        MixedKronMatvec)
    cfg, table, b, sec = _flagship()
    ref = b.matvec_builder(sec)
    op = b.op_cache[sec.index]
    assert type(ref) is KronMatvec and ref.dtype == jnp.float64
    v = jax.device_put(jnp.asarray(
        np.random.default_rng(0).normal(size=sec.dim)))
    w_ref = np.asarray(apply_once(ref, v))
    rec["dim"] = sec.dim
    for name, mv in (("kron_f64", ref), ("exact_ell_f64", ExactKronMatvec(op)),
                     ("mixed_ds", MixedKronMatvec(op))):
        _rate(name, mv, v, rec)
        if mv is not ref:
            w = np.asarray(apply_once(mv, v))
            rec[f"{name}_rel_err"] = float(np.abs(w - w_ref).max()
                                           / np.abs(w_ref).max())
        del mv


def _joint_problem(mode):
    from edipack_tpu.bath.dmft_bath import init_bath
    from edipack_tpu.config import default_config
    from edipack_tpu.sectors import SectorTable
    from edipack_tpu.umatrix import build_umatrix
    if mode == "superc":
        cfg = default_config(norb=2, nbath=5, nspin=1, ed_mode="superc",
                             uloc=[-2.0, -2.0], ust=-1.0, jh=0.25, jx=0.25,
                             jp=0.25, deltasc=0.02)
        hloc = np.zeros((1, 1, 2, 2))
        qn = ("sz", 0)
    else:
        cfg = default_config(norb=2, nbath=5, nspin=2, ed_mode="nonsu2",
                             uloc=[2.0, 2.0], ust=1.2, jh=0.25,
                             spin_field_x=[0.1, 0.1])
        hloc = np.zeros((2, 2, 2, 2), complex)
        hloc[0, 1] = 0.1j * np.eye(2)        # SOC-like spin-mixing block
        hloc[1, 0] = -0.1j * np.eye(2)
        qn = ("nt", 12)
    table = SectorTable(cfg)
    return cfg, table.by_qn(qn), hloc, build_umatrix(cfg), init_bath(cfg)


def bench_joint(mode, rec):
    """ELL JointMatvec c128 against blocked-Kron c128 on one large joint
    sector; the faster one is what ed_joint_kron=auto should pick."""
    import jax
    import jax.numpy as jnp
    from edipack_tpu.models.joint import build_joint_sector_op
    from edipack_tpu.models.joint_kron import build_joint_kron_op
    from edipack_tpu.ops.matvec import JointMatvec
    cfg, sec, hloc, um, bath = _joint_problem(mode)
    rng = np.random.default_rng(0)
    vs = rng.normal(size=sec.dim) + 1j * rng.normal(size=sec.dim)
    rec["dim"] = sec.dim

    log(f"{mode}: sector {sec.qn} dim {sec.dim}")
    t0 = time.perf_counter()
    kr = build_joint_kron_op(cfg, sec, hloc, um, bath)
    rec["kron_build_s"] = time.perf_counter() - t0
    log(f"{mode}: blocked-Kron built in {rec['kron_build_s']:.1f} s")
    # the sorted and blocked layouts are one permutation apart (no padding
    # without a mesh): compare both operators on the same state
    assert kr.dim == sec.dim
    vk = jax.device_put(jnp.asarray(vs))
    _rate("kron_c128", kr, vk, rec)
    w_kr = np.asarray(apply_once(kr, vk))
    v = jax.jit(lambda op, u: op.from_internal_flat(u))(kr, vk)
    w_kr = np.asarray(jax.jit(lambda op, u: op.from_internal_flat(u))(
        kr, jax.device_put(jnp.asarray(w_kr))))
    del kr, vk

    t0 = time.perf_counter()
    ell = JointMatvec(build_joint_sector_op(cfg, sec, hloc, um, bath))
    rec["ell_build_s"] = time.perf_counter() - t0
    log(f"{mode}: padded-ELL built in {rec['ell_build_s']:.1f} s")
    _rate("ell_c128", ell, v, rec, reps=5)
    w_ell = np.asarray(apply_once(ell, v))
    rec["kron_vs_ell_rel_diff"] = float(np.abs(w_kr - w_ell).max()
                                        / np.abs(w_ell).max())
    rec["faster"] = ("kron" if rec["kron_c128_ms"] < rec["ell_c128_ms"]
                     else "ell")


def bench_phonon(rec):
    import jax
    import jax.numpy as jnp
    from chip_smoke import flagship
    kw = dict(norb=3, nbath=3, nspin=1, uloc=[2.0, 2.0, 2.0], ust=1.2,
              jh=0.2, nph=3, w0_ph=0.5, g_ph=[0.2, 0.2, 0.2])
    cfg, table, b, sec = flagship(kw, (6, 6))
    mv = b.matvec_builder(sec)
    rec["operator"] = type(mv).__name__
    v = jax.device_put(jnp.asarray(
        np.random.default_rng(0).normal(size=mv.dim)))
    _rate("production", mv, v, rec)


def bench_gs(rec):
    from chip_smoke import E0_FLAGSHIP, sector_e0
    cfg, table, b, sec = _flagship()
    rec["operator"] = type(b.matvec_builder(sec)).__name__
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        e0 = sector_e0(cfg, table, b, sec)
        rec[f"{tag}_s"] = time.perf_counter() - t0
        rec[f"{tag}_e0"] = e0
        log(f"gs {tag}: E0 {e0:.10f} in {rec[f'{tag}_s']:.3f} s")
    rec["abs_de0"] = abs(rec["warm_e0"] - E0_FLAGSHIP)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", choices=SECTIONS, action="append")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX reports {dev.platform!r}",
              file=sys.stderr)
        return 2
    from edipack_tpu.utils.jax_cache import enable_compile_cache
    enable_compile_cache()
    card = power_limit()
    print(card, flush=True)
    fns = {"normal": bench_normal, "superc": lambda r: bench_joint("superc", r),
           "nonsu2": lambda r: bench_joint("nonsu2", r),
           "phonon": bench_phonon, "gs": bench_gs}
    out = {}
    for name in args.section or SECTIONS:
        rec = {"platform": dev.platform, "device_kind": dev.device_kind,
               "count": len(jax.devices()), "nvidia_smi": card}
        t0 = time.perf_counter()
        fns[name](rec)
        rec["section_s"] = time.perf_counter() - t0
        print(json.dumps({name: rec}), flush=True)
        out[name] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
