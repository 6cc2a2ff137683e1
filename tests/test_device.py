"""The backend helper (hpddm_tpu.device) and the chip smoke script's
refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hpddm_tpu import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_platform_is_cpu_here():
    assert device.platform() == "cpu"


def test_working_dtype_cpu():
    assert device.working_dtype() is np.float64
    assert device.working_dtype(complex_=True) is np.complex128


def test_working_dtype_gpu(monkeypatch):
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    assert device.working_dtype() is np.float32
    assert device.working_dtype(complex_=True) is np.complex64


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_banded_factor_place_follows_working_dtype(monkeypatch):
    """f32 banded factors run on the device only where f32 is the working
    dtype (the GPU); on the CPU they take the host f64 path."""
    from hpddm_tpu.models import diffusion2d
    from hpddm_tpu.ops.banded_solve import build_banded_solver

    gen = diffusion2d.generate_uniform(4, 16, 16, overlap=1,
                                       dtype=np.float32)
    boxes = [(0, i1 - i0, 0, j1 - j0) for (i0, i1, j0, j1) in gen.boxes]
    n_max = max(gen.n_loc)
    seen = []
    import hpddm_tpu.ops.banded_solve as bs
    real = bs._schur_device
    monkeypatch.setattr(bs, "_schur_device",
                        lambda *a, **k: seen.append("device") or real(*a, **k))
    build_banded_solver(gen.mats, boxes, n_max, dtype=np.float32)
    assert seen == []
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    build_banded_solver(gen.mats, boxes, n_max, dtype=np.float32)
    assert seen == ["device"]


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits nonzero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass
