"""CLI drivers exercised end-to-end in subprocesses (the cross-language
consistency role of the reference's make test: every driver must exit 0
under its embedded oracles)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=8")


def _run(args, timeout=500):
    bootstrap = (
        "import sys, jax; jax.config.update('jax_platforms','cpu'); "
        "jax.config.update('jax_enable_x64', True); "
        f"sys.argv = ['x'] + {args[1:]!r}; "
        f"import runpy; runpy.run_path({os.path.join(ROOT, args[0])!r}, "
        "run_name='__main__')")
    # load-aware timeout: these subprocesses are CPU-bound and slow down
    # proportionally when the host is contended (e.g. two suites
    # overlapping) — scale the budget by the current load per core
    load = os.getloadavg()[0]
    ncpu = os.cpu_count() or 1
    budget = timeout * max(1.0, min(4.0, load / ncpu + 1.0))
    try:
        return subprocess.run([sys.executable, "-c", bootstrap], cwd=ROOT,
                              env=ENV, timeout=budget, capture_output=True,
                              text=True)
    except subprocess.TimeoutExpired:
        # one retry: transient contention, not a driver failure
        return subprocess.run([sys.executable, "-c", bootstrap], cwd=ROOT,
                              env=ENV, timeout=budget, capture_output=True,
                              text=True)


@pytest.mark.parametrize("args", [
    ["examples/schwarz.py", "-N", "4", "-Nx", "50", "-Ny", "50"],
    ["examples/schwarz.py", "-N", "4", "-Nx", "50", "-Ny", "50",
     "-hpddm_schwarz_coarse_correction", "deflated", "-hpddm_geneo_nu", "4"],
    ["examples/solver.py"],
    ["examples/iterative.py"],
])
def test_driver_exits_zero(args):
    r = _run(args)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])


def test_driver_gcrodr_sequence():
    # reference-scale sequence (10 x n=2025, restart 40): heavier than the
    # other drivers
    r = _run(["examples/driver.py"], timeout=900)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "GCRODR" in r.stdout


@pytest.mark.parametrize("args", [
    ["examples/helmholtz.py", "-N", "4", "-Nx", "40", "-k", "4.0",
     "-eps", "0.1"],
    ["examples/elasticity.py", "-N", "4", "-Nx", "16",
     "-hpddm_schwarz_coarse_correction", "deflated",
     "-hpddm_geneo_nu", "6"],
    ["examples/diffusion3d.py", "-N", "8", "-Nx", "16", "-contrast", "1e3",
     "-hpddm_schwarz_coarse_correction", "deflated",
     "-hpddm_geneo_nu", "6"],
    ["examples/elasticity.py", "-N", "4", "-Nx", "8", "-dim", "3",
     "-hpddm_schwarz_coarse_correction", "deflated",
     "-hpddm_geneo_nu", "8"],
    ["examples/stokes.py", "-N", "4", "-Nc", "24",
     "-hpddm_schwarz_coarse_correction", "deflated",
     "-hpddm_geneo_nu", "8"],
    ["examples/least_squares.py", "-N", "4", "-Nx", "24",
     "-hpddm_schwarz_coarse_correction", "additive",
     "-hpddm_geneo_nu", "4"],
    ["examples/custom_operator.py", "-n", "60", "-mu", "2"],
    ["examples/unstructured.py", "-N", "8", "-Nx", "50", "-contrast", "1e4",
     "-hpddm_schwarz_coarse_correction", "deflated", "-hpddm_geneo_nu", "8",
     "-hpddm_tol", "1e-8"],
])
def test_model_drivers(args):
    r = _run(args)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])


def test_oracle_cpu_f32_iterations(monkeypatch, capsys):
    """The 100^2/4 two-level GenEO oracle in f32 on the CPU takes exactly
    the count chip_smoke.py's phase 1 compares the GPU with (+-2)."""
    import numpy as np
    sys.path.insert(0, ROOT)
    import chip_smoke
    import examples.schwarz as drv
    import hpddm_tpu.device as device

    monkeypatch.setattr(device, "working_dtype",
                        lambda complex_=False: np.float32)
    assert drv.main(list(chip_smoke.ORACLE_ARGS)) == 0
    out = capsys.readouterr().out
    assert f"converges after {chip_smoke.ORACLE_CPU_F32_ITS} iterations" \
        in out, out[-2000:]
