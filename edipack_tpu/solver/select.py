"""Which sector matvec the solver builds.

Every choice here reads the config and the sector only, never the device the
program runs on, so one config gives the same operator on every backend.
The defaults follow the H100 timings in PERF.md; CPU runs take the same
path."""
from __future__ import annotations

from ..config import EDConfig
from ..sectors import Sector


def normal_mixed(cfg: EDConfig) -> bool:
    """Double-single normal-mode matvec (``MixedKronMatvec``) with an exact
    f64 twin for the polish.  Only on request: ``auto`` is native f64."""
    return cfg.ed_precision == "float64" and cfg.ed_mixed_matvec == "always"


def joint_mixed(cfg: EDConfig) -> bool:
    """Double-single blocked-Kron pair operator (``MixedJointKron``) for the
    joint modes.  Only on request: ``auto`` is native c128."""
    return cfg.ed_mixed_matvec == "always"


def joint_kron(cfg: EDConfig, sec: Sector) -> bool:
    """Blocked-Kron (``build_joint_kron_op``) rather than padded-ELL
    (``JointMatvec``) for a joint sector.  Only on request: ELL c128 ran
    twice as fast as blocked-Kron c128 on the 2.7M-dim superc and nonsu2
    sectors (H100, PERF.md), so ``auto`` is ELL.  Jz-filtered sectors have
    no blocked form."""
    return cfg.ed_joint_kron == "always" and sec.qn[0] in ("sz", "nt")
