"""Input-variable system.

Parity target: reference ED_INPUT_VARS.f90 (ed_read_input, :565-885): every
variable has a default, a file override (``VAR=value`` lines) and a
command-line override, is echoed back into ``used.<input>``, and a documented
comment. Variables are grouped in one dataclass instead of Fortran globals;
a module-level "current config" mirrors the reference's global mutable state
so the `ed_*` functional API works the same way.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _norb_list(default: float, n: int = 5) -> List[float]:
    return [default] * n


# list-valued fields that accept a scalar broadcast (exc_field excluded: its
# 4 entries are distinct S0/Tx/Ty/Tz components)
_LIST_FIELDS = ("uloc", "g_ph", "spin_field_x", "spin_field_y",
                "spin_field_z", "pair_field")


@dataclass
class EDConfig:
    # ---- system dimensions (ED_INPUT_VARS.f90:594-598)
    norb: int = 1            # number of impurity orbitals (max 5)
    nbath: int = 6           # bath levels (normal: per orb; hybrid: total; replica/general: #replicas)
    nspin: int = 1           # spin degeneracy (max 2)
    nph: int = 0             # max phonon number (cutoff)
    bath_type: str = "normal"  # normal | hybrid | replica | general

    # ---- interaction (Kanamori) (:605-611)
    uloc: List[float] = field(default_factory=lambda: _norb_list(2.0))
    ust: float = 0.0
    jh: float = 0.0
    jx: float = 0.0
    jp: float = 0.0

    # ---- DMFT loop control (:614-621)
    nloop: int = 100
    nsuccess: int = 1
    dmft_error: float = 1e-5
    # symmetry-breaking field: exported for user drivers (the reference
    # library itself has no consumer; test drivers seed replica lambdas
    # with it, ed_replica_nonsu2.f90)
    sb_field: float = 0.1
    deltasc: float = 0.02
    beta: float = 1000.0     # inverse temperature (IR cutoff at T=0)
    xmu: float = 0.0

    # ---- phonons (:626-629)
    g_ph: List[float] = field(default_factory=lambda: _norb_list(0.0))
    w0_ph: float = 0.0
    a_ph: float = 0.0
    gphfile: str = "NONE"

    # ---- fields (:637-644)
    spin_field_x: List[float] = field(default_factory=lambda: _norb_list(0.0))
    spin_field_y: List[float] = field(default_factory=lambda: _norb_list(0.0))
    spin_field_z: List[float] = field(default_factory=lambda: _norb_list(0.0))
    exc_field: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0])
    pair_field: List[float] = field(default_factory=lambda: _norb_list(0.0))

    # ---- response-function flags (:648-656)
    chispin_flag: bool = False
    chidens_flag: bool = False
    chipair_flag: bool = False
    chiexct_flag: bool = False
    rdm_flag: bool = False

    # ---- ED mode and solver switches (:660-690)
    ed_mode: str = "normal"  # normal | superc | nonsu2
    ed_finite_temp: bool = False
    ed_sectors: bool = False
    ed_sectors_shift: int = 1
    ed_sparse_h: bool = True   # True: stored operator; False: on-the-fly matvec
    ed_total_ud: bool = True   # True: total (Nup,Ndw); False: per-orbital QNs
    ed_twin: bool = False
    ed_read_umatrix: bool = False
    ed_use_kanamori: bool = True
    ed_obs_all: bool = True
    ed_solve_offdiag_gf: bool = False
    ed_print_sigma: bool = True
    ed_print_g: bool = True
    ed_print_g0: bool = True
    ed_print_chispin: bool = True
    ed_print_chidens: bool = True
    ed_print_chipair: bool = True
    ed_print_chiexct: bool = True
    ed_all_g: bool = True
    ed_verbose: int = 3
    ed_hw_bath: float = 2.0
    ed_offset_bath: float = 0.1

    # ---- grids (:694-714)
    lmats: int = 4096
    lreal: int = 5000
    ltau: int = 1024
    ltimes: int = 1000
    lfit: int = 1000
    lpos: int = 100
    nread: float = 0.0
    nerr: float = 1e-4
    ndelta: float = 0.1
    ncoeff: float = 1.0
    wini: float = -5.0
    wfin: float = 5.0
    tmax: float = 10.0
    xmin: float = -3.0
    xmax: float = 3.0

    # ---- numerics (:717-732)
    hfmode: bool = True
    eps: float = 0.01        # real-axis broadening
    cutoff: float = 1e-9     # spectrum cutoff for retained states
    gs_threshold: float = 1e-9
    lanc_method: str = "arpack"  # arpack | lanczos (both map to on-device Lanczos here)
    lanc_nstates_sector: int = 2
    lanc_nstates_total: int = 1
    lanc_nstates_step: int = 2
    lanc_ncv_factor: int = 10
    lanc_ncv_add: int = 0
    lanc_niter: int = 512
    lanc_ngfiter: int = 200
    lanc_tolerance: float = 1e-18
    lanc_dim_threshold: int = 1024  # dense diagonalization below this dim

    # ---- chi^2 fit (:735-745)
    cg_method: int = 0
    cg_grad: int = 0
    cg_ftol: float = 1e-5
    cg_stop: int = 0
    cg_niter: int = 500
    cg_weight: int = 1       # 1: 1.0, 2: 1/n, 3: 1/w_n
    cg_scheme: str = "weiss"  # weiss | delta
    cg_norm: str = "elemental"  # elemental | frobenius
    cg_pow: int = 2
    # legacy knobs of the reference's cg_method=1 'minimize' backend
    # (Krauth vs Lichtenstein); this engine's cg_method=1 maps to scipy
    # L-BFGS-B, which has no equivalent switches
    cg_minimize_ver: bool = False
    cg_minimize_hh: float = 1e-4

    # ---- nonsu2 Jz basis (:757-759)
    jz_basis: bool = False
    jz_max: bool = False
    jz_max_value: float = 1000.0

    # ---- files (:762-769)
    sectorfile: str = "sectors"
    hfile: str = "hamiltonian"
    bfile: str = "hbasis"
    # legacy parity: the reference exports HLOCfile but never reads it
    # (only re-exported at EDIPACK.f90:20); Hloc enters via ed_set_hloc
    hlocfile: str = "inputHLOC.in"
    umatrix_file: str = "umatrix"
    print_input_vars: bool = True
    print_sector_eigenvalues: bool = True
    logfile: int = 6

    # ---- additions of this engine (no reference counterpart)
    ed_precision: str = "float64"   # float64 | float32 : dtype of the matvec path
    # "always" runs Lanczos matvecs in double-single f32 (~3e-7 matvec
    # error) with an exact f64 Rayleigh-Ritz refinement of the converged
    # subspace; "auto" and "never" run native f64 (c128 in the joint
    # modes). GF moments stay exact f64 unless ed_mixed_gf.
    ed_mixed_matvec: str = "auto"   # auto | always | never
    # GF tridiagonalization also runs on the split-f32 matvec where the
    # matvec is mixed: the ~3e-7 matvec noise enters poles/weights at
    # ~1e-6*||H|| — far below the spectral broadening (eps default 1e-2).
    # Set False to force exact-f64 GF moments.
    ed_mixed_gf: bool = True
    ed_dense_factors: bool = True   # normal mode: dense spin-factor matmul path
    ed_batch_dense: bool = True     # batch small sectors into one padded eigh
    # lockstep-batch same-shape Lanczos sectors (cross-site and PH partners)
    # into single vmapped DS-sweep launches (diag.py; batched form of the
    # reference's serial sector loop, ED_DIAG_NORMAL.f90:108)
    ed_batch_lanczos: bool = True
    ed_file_suffix: str = ""        # per-site suffix (ineq extension)
    ed_output_dir: str = "."        # where .ed text outputs are written
    ed_write_files: bool = False    # write observables_*.ed etc. text files
    ed_joint_kron: str = "auto"     # superc/nonsu2 matvec: "always" =
    #                                 blocked-Kron operator; "auto"/"never"
    #                                 = sorted padded-ELL (solver/select.py)
    ed_profile_dir: str = ""        # write a JAX profiler trace of each
    #                                 solve here (view with tensorboard /
    #                                 xprof; EDIPACK_TPU_PROFILE_DIR env
    #                                 var overrides)
    ed_sanitize: bool = False       # debug-build analog of the reference's
    #                                 BUILD_TYPE=DEBUG/TESTING (-fcheck=all,
    #                                 -fbacktrace; reference CMakeLists):
    #                                 traps NaNs in jitted code and runs
    #                                 Hermiticity / finiteness self-checks
    #                                 on every sector operator and spectrum
    #                                 (EDIPACK_TPU_SANITIZE=1 env overrides)

    # ------------------------------------------------------------------
    @property
    def uloc_used(self) -> List[float]:
        return list(self.uloc[: self.norb])

    def replace(self, **kw) -> "EDConfig":
        # coerce scalars into the list-valued fields (the reference accepts
        # ULOC=2.0 as a broadcast vector; the C set_option path sends scalars)
        for name in _LIST_FIELDS:
            if name in kw and np.isscalar(kw[name]):
                kw[name] = [float(kw[name])] * 5
        return dataclasses.replace(self, **kw)

    # -- validation (parity: ED_INPUT_VARS.f90:771-795, ED_SETUP.f90:32-100)
    def validate(self) -> None:
        if self.norb < 1 or self.norb > 5:
            raise ValueError("norb must be in 1..5")
        if self.nspin not in (1, 2):
            raise ValueError("nspin must be 1 or 2")
        if self.ed_mode not in ("normal", "superc", "nonsu2"):
            raise ValueError(f"invalid ed_mode {self.ed_mode}")
        if self.bath_type not in ("normal", "hybrid", "replica", "general"):
            raise ValueError(f"invalid bath_type {self.bath_type}")
        if self.ed_mode == "superc" and self.nspin != 1:
            raise ValueError("superc requires nspin=1 (Nambu doubling is internal)")
        if self.ed_mode == "nonsu2" and self.nspin != 2:
            raise ValueError("nonsu2 requires nspin=2")
        if not self.ed_total_ud:
            if self.bath_type == "hybrid":
                raise ValueError("ed_total_ud=False incompatible with hybrid bath")
            if self.ed_mode != "normal":
                raise ValueError("ed_total_ud=False requires ed_mode=normal")
        if self.ed_finite_temp and self.lanc_nstates_total == 1:
            raise ValueError("ed_finite_temp requires lanc_nstates_total > 1")
        if self.lanc_method not in ("arpack", "lanczos"):
            raise ValueError(
                f"lanc_method '{self.lanc_method}' not supported: this "
                "engine provides restarted deflated Lanczos ('arpack' "
                "semantics) and plain long-sweep Lanczos ('lanczos'); "
                "dvdson has no equivalent")
        if self.cg_norm not in ("elemental", "frobenius"):
            raise ValueError("cg_norm must be 'elemental' or 'frobenius'")
        if self.cg_stop not in (0, 1, 2):
            raise ValueError("cg_stop must be 0, 1 or 2")
        if self.ed_mixed_matvec not in ("auto", "always", "never"):
            raise ValueError("ed_mixed_matvec must be auto|always|never")
        if self.jz_basis:
            if self.ed_mode != "nonsu2":
                raise ValueError("jz_basis requires ed_mode=nonsu2")
            if self.norb != 3:
                raise ValueError("jz_basis requires norb=3 (t2g effective "
                                 "L=1 basis, Lzdiag=[-1,+1,0])")
            if self.bath_type == "hybrid":
                raise ValueError("jz_basis: hybrid bath levels carry no "
                                 "orbital character")


# ---------------------------------------------------------------------------
# parsing (reference SF_PARSE_INPUT semantics: file lines VAR=value, CLI
# overrides VAR=value, case-insensitive names, comment echo to used.<file>)
# ---------------------------------------------------------------------------

_FIELDS = {f.name: f for f in dataclasses.fields(EDConfig)}
# reference names are uppercase; accept any case
_ALIASES = {name.upper(): name for name in _FIELDS}
_ALIASES.update({"G_PH": "g_ph", "GPHFILE": "gphfile"})


def _parse_value(raw: str, pyname: str):
    f = _FIELDS[pyname]
    raw = raw.strip()
    ftype = f.type if isinstance(f.type, str) else str(f.type)
    if "bool" in ftype:
        return raw.upper().startswith("T") or raw == "1" or raw.upper() == ".TRUE."
    if "int" in ftype and "List" not in ftype:
        return int(float(raw.replace("d", "e").replace("D", "e")))
    if "float" in ftype and "List" not in ftype:
        return float(raw.replace("d", "e").replace("D", "e"))
    if "List" in ftype:
        parts = [p for p in raw.replace(",", " ").split() if p]
        return [float(p.replace("d", "e").replace("D", "e")) for p in parts]
    return raw  # string


def parse_input_file(path: str) -> dict:
    """Parse an EDIpack-style input file into a dict of overrides."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            line = line.split("!")[0].split("#")[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip().upper()
            if key in _ALIASES:
                pyname = _ALIASES[key]
                out[pyname] = _parse_value(val, pyname)
    return out


def parse_cli(argv: Optional[List[str]] = None) -> dict:
    """Parse VAR=value command-line overrides (reference CLI semantics)."""
    out = {}
    for tok in argv if argv is not None else sys.argv[1:]:
        if "=" not in tok:
            continue
        key, _, val = tok.partition("=")
        key = key.strip().lstrip("-").upper()
        if key in _ALIASES:
            pyname = _ALIASES[key]
            out[pyname] = _parse_value(val, pyname)
    return out


def ed_read_input(path: str = "inputED.in", argv: Optional[List[str]] = None,
                  write_used: bool = True, **extra) -> EDConfig:
    """Build an :class:`EDConfig` from file + CLI + kwargs and install it as
    the current global config (reference `ed_read_input`, ED_INPUT_VARS.f90:565).
    Writes the ``used.<input>`` echo file like the reference (:852-858)."""
    overrides = parse_input_file(path)
    overrides.update(parse_cli(argv))
    overrides.update(extra)
    cfg = EDConfig(**overrides)
    cfg.validate()
    set_config(cfg)
    if write_used:
        try:
            save_used(cfg, os.path.join(
                os.path.dirname(path) or ".", "used." + os.path.basename(path)))
        except OSError:
            pass
    return cfg


def save_used(cfg: EDConfig, path: str) -> None:
    with open(path, "w") as fh:
        for f in dataclasses.fields(EDConfig):
            v = getattr(cfg, f.name)
            if isinstance(v, bool):
                sv = "T" if v else "F"
            elif isinstance(v, list):
                sv = ",".join(str(x) for x in v)
            else:
                sv = str(v)
            fh.write(f"{f.name.upper()}={sv}\n")


# ---------------------------------------------------------------------------
# module-level current config (the reference keeps these as Fortran globals)
# ---------------------------------------------------------------------------
_current: EDConfig = EDConfig()


def get_config() -> EDConfig:
    return _current


def set_config(cfg: EDConfig) -> EDConfig:
    global _current
    _current = cfg
    return cfg


def default_config(**kw) -> EDConfig:
    cfg = EDConfig(**kw)
    cfg.validate()
    return cfg


def update_config(**kw) -> EDConfig:
    """Runtime-mutable update (reference `ed_update_input`, :887-916)."""
    return set_config(get_config().replace(**kw))
