"""Package rules of the port: it imports neither JAX nor anything of
za_tpu; its engine needs CUDA unless a device is given; its kernel
wrappers never take a CPU path for CUDA work; chip_smoke.py refuses to
run without a card or without the package."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from za_tpu_torch.engine import _build
from za_tpu_torch.engine.engine import GpuEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import za_tpu_torch
for m in pkgutil.walk_packages(za_tpu_torch.__path__, "za_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "za_tpu"
             or m.startswith("za_tpu."))
print(len([m for m in sys.modules if m.startswith("za_tpu_torch")]))
assert not bad, bad
"""


def test_package_imports_no_jax_and_no_za_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHECK.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module was imported


def test_engine_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuEngine()
    assert GpuEngine(device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_only_cuda_tensors():
    x = torch.zeros(8, 4, dtype=torch.int32)
    names = {"tree_level0_g1", "tree_level_g1", "tree_level0_g2",
             "tree_level_g2", "ec_add_g1", "ec_add_g2", "to_affine_g1",
             "to_affine_g2", "horner_g1", "horner_g2", "ntt_stage_fr",
             "dense_window_sums_g1", "dense_window_sums_g2",
             "dense4_window_sums_g1", "dense4_window_sums_g2",
             "ntt_prefix_fr", "ntt_twiddle_fr", "r1cs_matvec_fr",
             "ec_fold_g1", "ec_fold_g2", "ec_carry_g1", "ec_carry_g2"}
    assert names <= set(_build.KERNELS)
    for name in names:
        k = _build.KERNELS[name]
        args = [x if c == "p" else 4 for c in k.argspec]
        with pytest.raises(ValueError, match="CUDA tensors"):
            k(*args)
        assert k.launches == 0


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for script in (os.path.join(ROOT, "chip_smoke.py"), alone):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=300,
                             cwd=os.path.dirname(script))
        assert out.returncode != 0
        assert out.stdout == ""
