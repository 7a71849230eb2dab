"""The C ABI (embedded-Python bindings) drives the solver end-to-end and
reproduces the Python-side observables."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI = os.path.join(REPO, "edipack_tpu", "capi")

DRIVER = r"""
#include <stdio.h>
#include "edipack_tpu.h"
int main(void) {
  if (edtpu_init()) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  edtpu_set_option_i("norb", 1);
  edtpu_set_option_i("nbath", 2);
  edtpu_set_option_d("xmu", 0.17);
  edtpu_set_option_i("ed_verbose", 0);
  int nb = edtpu_get_bath_dimension();
  double bath[64];
  if (edtpu_init_solver(bath, nb)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  double re[1] = {0.0};
  edtpu_set_hloc(re, 0, 1);
  if (edtpu_solve(bath, nb)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  double dens[1];
  edtpu_get_dens(dens, 1);
  printf("DENS %.12f\n", dens[0]);
  edtpu_finalize();
  return 0;
}
"""


@pytest.mark.skipif(not os.path.exists(os.path.join(CAPI, "edipack_tpu.h")),
                    reason="capi sources missing")
def test_c_driver_matches_python(tmp_path):
    # build the shared lib + driver
    r = subprocess.run(["make", "-C", CAPI, "-s"], capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"capi build failed: {r.stderr.decode()[:200]}")
    src = tmp_path / "driver.c"
    src.write_text(DRIVER)
    exe = tmp_path / "driver"
    r = subprocess.run(
        ["gcc", "-O2", "-I", CAPI, "-o", str(exe), str(src),
         "-L", CAPI, "-ledipack_tpu_c", f"-Wl,-rpath,{CAPI}"],
        capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"driver build failed: {r.stderr.decode()[:200]}")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([str(exe)], capture_output=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    text = out.stdout.decode()
    assert "DENS" in text, text + out.stderr.decode()[-300:]
    dens_c = float(text.split("DENS")[1].split()[0])

    # python reference
    from edipack_tpu.config import default_config
    from edipack_tpu.bath.dmft_bath import init_bath
    from edipack_tpu.solver.core import solve_impurity
    from edipack_tpu.umatrix import build_umatrix
    cfg = default_config(norb=1, nbath=2, nspin=1, xmu=0.17)
    res = solve_impurity(cfg, np.zeros((1, 1, 1, 1)), build_umatrix(cfg),
                         init_bath(cfg))
    assert abs(dens_c - res.dens[0]) < 1e-9


DRIVER_EXT = r"""
#include <stdio.h>
#include "edipack_tpu.h"
int main(void) {
  if (edtpu_init()) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  edtpu_set_option_i("norb", 1);
  edtpu_set_option_i("nbath", 2);
  edtpu_set_option_d("xmu", 0.0);
  edtpu_set_option_i("ed_verbose", 0);
  edtpu_set_option_i("lmats", 8);
  edtpu_set_option_i("ed_use_kanamori", 0);
  int nb = edtpu_get_bath_dimension();
  double bath[64];
  if (edtpu_init_solver(bath, nb)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  /* runtime umatrix: U n_up n_dw at orbital 1 (w2dynamics double-count
   * convention: both spin orderings at U, reference test pattern) */
  if (edtpu_add_twobody_operator(1, 1, 1, 2, 1, 1, 1, 2, 2.0)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  if (edtpu_add_twobody_operator(1, 2, 1, 1, 1, 2, 1, 1, 2.0)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  double re[1] = {0.0};
  edtpu_set_hloc(re, 0, 1);
  /* statics-only solve */
  if (edtpu_solve_flag(bath, nb, 0)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  double mag[1];
  if (edtpu_get_mag("z", mag, 1)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  printf("MAGZ %.12f\n", mag[0]);
  double doubles[4];
  edtpu_get_doubles(doubles);
  double docc[1];
  edtpu_get_docc(docc, 1);
  printf("DOCC %.12f\n", docc[0]);
  /* full solve + complex getters */
  if (edtpu_solve_flag(bath, nb, 1)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  double g[2 * 8];
  if (edtpu_get_gimp_axis("m", "n", g, 8)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  printf("GIW0 %.12f %.12f\n", g[0], g[1]);
  /* mu controller */
  double mu = 0.0;
  int conv = 0;
  edtpu_set_option_d("nread", 1.0);
  if (edtpu_search_variable(&mu, 0.9, &conv)) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  printf("MU %.6f CONV %d\n", mu, conv);
  edtpu_finalize();
  return 0;
}
"""


@pytest.mark.skipif(not os.path.exists(os.path.join(CAPI, "edipack_tpu.h")),
                    reason="capi sources missing")
def test_c_driver_extended_surface(tmp_path):
    """flag_gf solves, runtime umatrix, mag/doubles/complex getters and the
    mu controller through the C ABI (reference edipack_cbindings.h parity)."""
    r = subprocess.run(["make", "-C", CAPI, "-s"], capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"capi build failed: {r.stderr.decode()[:200]}")
    src = tmp_path / "driver_ext.c"
    src.write_text(DRIVER_EXT)
    exe = tmp_path / "driver_ext"
    r = subprocess.run(
        ["gcc", "-O2", "-I", CAPI, "-o", str(exe), str(src),
         "-L", CAPI, "-ledipack_tpu_c", f"-Wl,-rpath,{CAPI}"],
        capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"driver build failed: {r.stderr.decode()[:200]}")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([str(exe)], capture_output=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    text = out.stdout.decode()
    assert "ERR" not in text, text + out.stderr.decode()[-300:]
    # half filling, no field: magz = 0
    magz = float(text.split("MAGZ")[1].split()[0])
    assert abs(magz) < 1e-8
    docc = float(text.split("DOCC")[1].split()[0])
    assert 0.0 < docc < 0.25    # U suppresses double occupancy
    gre, gim = map(float, text.split("GIW0")[1].split()[:2])
    assert gim < 0              # Im G(iw0) < 0
    assert abs(gre) < 1e-8      # ph-symmetric: Re G(iw0) = 0
    mu_line = text.split("MU")[1]
    assert float(mu_line.split()[0]) != 0.0   # controller moved mu


def test_capihelp_ineq_and_replica_helpers(tmp_path):
    """Python-level checks of the flat-buffer helpers the C ABI marshals
    through (edipack_tpu.capihelp)."""
    import edipack_tpu.capihelp as ch
    from edipack_tpu.config import default_config, set_config

    cfg = default_config(norb=1, nbath=2, nspin=1, uloc=[1.5], lmats=8,
                         ed_output_dir=str(tmp_path))
    set_config(cfg)
    ch.ineq_init(2)
    baths = ch.ineq_init_solver()
    nb = baths.shape[1]
    ch.ineq_set_hloc([0.2, -0.2], None, 1, per_site=1)
    ch.ineq_solve(baths.ravel(), nb, flag_gf=1)
    dens = ch.ineq_get("dens")
    assert dens.shape == (2, 1)
    assert dens[0, 0] < dens[1, 0]
    g = ch.ineq_get("gimp")
    assert g.shape[0] == 2 and np.iscomplexobj(g)

    # replica basis through the flat setter
    cfg2 = default_config(norb=1, nbath=2, nspin=1, bath_type="replica",
                          uloc=[1.0], ed_output_dir=str(tmp_path))
    set_config(cfg2)
    eye = np.zeros((1, 1, 1, 1, 1)); eye[0, 0, 0, 0, 0] = 1.0
    ch.set_hreplica_flat(eye.ravel().tolist(), None, 1, 1, 1, [0.3], 2)
    import edipack_tpu as ed
    bath = ed.ed_init_solver(cfg=cfg2)
    ed.ed_set_hloc(np.zeros((1, 1)))
    res = ed.ed_solve(bath)
    assert res.e0 < 0


INIT_DRIVER = r"""
#include <stdio.h>
#include "edipack_tpu.h"
int main(void) {
  if (edtpu_init()) { printf("ERR %s\n", edtpu_last_error()); return 1; }
  printf("OK\n");
  edtpu_finalize();
  return 0;
}
"""


@pytest.mark.skipif(not os.path.exists(os.path.join(CAPI, "edipack_tpu.h")),
                    reason="capi sources missing")
@pytest.mark.parametrize("platform,accepted", [
    ("cpu", True), ("rocm", False), ("cpu'); import os; ('", False)])
def test_c_platform_variable_is_validated(tmp_path, platform, accepted):
    """EDIPACK_TPU_PLATFORM takes cpu|gpu|cuda; anything else makes
    edtpu_init fail with the reason in edtpu_last_error()."""
    r = subprocess.run(["make", "-C", CAPI, "-s"], capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"capi build failed: {r.stderr.decode()[:200]}")
    src = tmp_path / "init.c"
    src.write_text(INIT_DRIVER)
    exe = tmp_path / "init"
    r = subprocess.run(
        ["gcc", "-O2", "-I", CAPI, "-o", str(exe), str(src),
         "-L", CAPI, "-ledipack_tpu_c", f"-Wl,-rpath,{CAPI}"],
        capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"driver build failed: {r.stderr.decode()[:200]}")
    env = dict(os.environ, PYTHONPATH=REPO, EDIPACK_TPU_PLATFORM=platform)
    out = subprocess.run([str(exe)], capture_output=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    text = out.stdout.decode()
    if accepted:
        assert out.returncode == 0 and "OK" in text, \
            text + out.stderr.decode()[-300:]
    else:
        assert out.returncode == 1
        assert "EDIPACK_TPU_PLATFORM must be cpu, gpu or cuda" in text
