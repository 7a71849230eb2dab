"""Backend-independence of the solver's path choices, the compile-cache
helper, and chip_smoke.py's phases at tiny size on the CPU (plus the same
phases on a GPU in a GPU run)."""
import os
import sys

import jax
import numpy as np
import pytest

from edipack_tpu.config import default_config
from edipack_tpu.sectors import SectorTable
from edipack_tpu.solver import select
from edipack_tpu.utils import jax_cache

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import bench  # noqa: E402
import chip_smoke  # noqa: E402

SMALL = dict(norb=2, nbath=2, nspin=1, uloc=[2.0, 2.0], ust=1.2, jh=0.2,
             jx=0.15, jp=0.15, lanc_dim_threshold=64, ed_verbose=0)


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = f"fake {platform}"


def _reporting(monkeypatch, platform):
    """Make jax.devices() report one device of ``platform``."""
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: [_FakeDevice(platform)])


def _joint_sector(mode, nbath=4):
    """Half-filled joint sector of a two-orbital impurity (nbath=4: dim
    C(20,10) = 184756)."""
    if mode == "superc":
        cfg = default_config(norb=2, nbath=nbath, nspin=1, ed_mode="superc",
                             uloc=[-2.0, -2.0], deltasc=0.02)
        return cfg, SectorTable(cfg).by_qn(("sz", 0))
    cfg = default_config(norb=2, nbath=nbath, nspin=2, ed_mode="nonsu2",
                         uloc=[2.0, 2.0], spin_field_x=[0.1, 0.1])
    return cfg, SectorTable(cfg).by_qn(("nt", 2 * (nbath + 1)))


def _choice(mode, option, monkeypatch, platform):
    _reporting(monkeypatch, platform)
    if mode == "normal":
        _cfg, _t, b, sec = chip_smoke.flagship(
            dict(SMALL, ed_mixed_matvec=option), (3, 3))
        mv = b.matvec_builder(sec)
        return type(mv).__name__, type(getattr(mv, "exact", None)).__name__
    cfg, sec = _joint_sector(mode)
    cfg = cfg.replace(ed_joint_kron=option)
    return select.joint_kron(cfg, sec), select.joint_mixed(cfg)


@pytest.mark.parametrize("mode,option", [
    ("normal", "auto"), ("normal", "always"), ("normal", "never"),
    ("superc", "auto"), ("superc", "always"), ("superc", "never"),
    ("nonsu2", "auto"), ("nonsu2", "always"), ("nonsu2", "never"),
])
def test_matvec_choice_ignores_platform(mode, option, monkeypatch):
    """The sector operator depends on the config and the sector only: the
    same whether the device reports itself as a GPU or as a CPU."""
    on_gpu = _choice(mode, option, monkeypatch, "gpu")
    on_cpu = _choice(mode, option, monkeypatch, "cpu")
    assert on_gpu == on_cpu
    if mode == "normal":
        want = "MixedKronMatvec" if option == "always" else "KronMatvec"
        assert on_cpu[0] == want
        if option == "always":
            assert on_cpu[1] == "KronMatvec"      # the exact f64 twin
    else:
        assert on_cpu == (option == "always", False)


@pytest.mark.parametrize("mode", ["superc", "nonsu2"])
def test_joint_kron_small_and_jz_sectors(mode):
    cfg, sec = _joint_sector(mode, nbath=2)
    assert not select.joint_kron(cfg, sec)        # auto: ELL
    assert select.joint_kron(cfg.replace(ed_joint_kron="always"), sec)
    cfg_n = default_config(norb=3, nbath=1, nspin=2, ed_mode="nonsu2",
                           jz_basis=True, ed_joint_kron="always")
    jz_sec = SectorTable(cfg_n).sector(0)
    assert jz_sec.qn[0] not in ("sz", "nt")
    assert not select.joint_kron(cfg_n, jz_sec)   # no blocked form


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir(env, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(jax_cache.CHECKOUT, ".jax_cache")
    assert jax_cache.compile_cache_dir() == want
    assert jax_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    # the default is the checkout's own, fixed, directory
    assert os.path.isfile(os.path.join(jax_cache.CHECKOUT, "chip_smoke.py"))


@pytest.mark.parametrize("script", [chip_smoke, bench])
def test_main_refuses_without_gpu(script, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert script.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""                      # no result line
    assert "needs a GPU" in out.err


@pytest.mark.parametrize("mode", ["normal", "superc", "nonsu2"])
def test_smoke_oracle_case_cpu(mode):
    err = chip_smoke.oracle_case(mode, jax.devices("cpu")[0])
    assert set(err) == set(chip_smoke.ORACLE_TOL)
    for k, v in err.items():
        assert v <= chip_smoke.ORACLE_TOL[k], (mode, k, v)


def test_smoke_matvec_and_e0_cpu():
    cpu = jax.devices("cpu")[0]
    rel = chip_smoke.phase_matvec(cpu, SMALL, (3, 3))
    assert rel <= chip_smoke.MATVEC_RTOL
    cfg, table, b, sec = chip_smoke.flagship(SMALL, (3, 3))
    e_ref = np.linalg.eigvalsh(b.dense_builder(sec))[0]
    cold, warm = chip_smoke.phase_e0(cpu, SMALL, (3, 3), e_ref)
    assert abs(cold - e_ref) < 1e-10 and abs(warm - e_ref) < 1e-10
    with pytest.raises(AssertionError):
        chip_smoke.phase_e0(cpu, SMALL, (3, 3), e_ref + 1e-6)


def test_smoke_full_solve_cpu():
    cpu = jax.devices("cpu")[0]
    kw = dict(SMALL, nbath=1, lmats=32)
    res = chip_smoke.phase_solve(cpu, kw, twin=True)
    assert res.cfg.ed_twin
    assert {"diagonalization", "greens_functions"} <= set(res.timings)


def test_smoke_four_virtual_devices():
    """The sharded-sector phase on the suite's virtual CPU mesh: the
    production builder shards dw over every device it sees."""
    devs = jax.devices()
    kw = dict(SMALL, nbath=3)                  # Ns=8: dim_dw C(8,3)=56
    cfg, table, b, sec = chip_smoke.flagship(kw, (3, 3))
    assert sec.dim_dw % len(devs) == 0
    e_ref = np.linalg.eigvalsh(b.dense_builder(sec))[0]
    chip_smoke.phase_four(devs, kw, (3, 3), e_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["normal", "superc", "nonsu2"])
def test_oracle_case_gpu(mode, gpu_device):
    err = chip_smoke.oracle_case(mode, gpu_device)
    for k, v in err.items():
        assert v <= chip_smoke.ORACLE_TOL[k], (mode, k, v)


@pytest.mark.gpu
def test_matvec_gpu_vs_host(gpu_device):
    kw = dict(SMALL, nbath=4)                  # Ns=10, sector (5,5): 252^2
    assert chip_smoke.phase_matvec(gpu_device, kw, (5, 5)) \
        <= chip_smoke.MATVEC_RTOL
