"""Boundaries of the port: no JAX inside it, the card by default, no
quiet fallback from the card to the plain versions."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sivf_torch
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + sorted(
    (REPO / "src" / "sivf_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "sivf"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_nothing_of_the_jax_package():
    assert len(PORT_FILES) > 15
    bad = {str(p.relative_to(REPO)): sorted(imported_roots(p) & FORBIDDEN)
           for p in PORT_FILES if imported_roots(p) & FORBIDDEN}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, sivf_torch, repro_torch.core, repro_torch.interop; "
            "import repro_torch.kernels.sivf_scan.ops; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'sivf')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_default_device_is_the_card():
    cfg = sivf_torch.SIVFConfig(dim=8, n_lists=2, n_slabs=4, capacity=32,
                                n_max=64)
    cents = np.zeros((2, 8), np.float32)
    if torch.cuda.is_available():
        assert sivf_torch.Index(cfg, cents).state.data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sivf_torch.Index(cfg, cents)
        with pytest.raises(RuntimeError):
            sivf_torch.init_state(cfg, cents)
    assert sivf_torch.Index(cfg, cents, device="cpu").device.type == "cpu"


def test_smoke_script_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory (no ``src/``) the smoke script prints no result
    and fails; without CUDA it does so in the checkout as well."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    scripts = [lone] if torch.cuda.is_available() else [
        REPO / "chip_smoke.py", lone]
    for script in scripts:
        r = subprocess.run([sys.executable, str(script)],
                           capture_output=True, text=True, timeout=120,
                           cwd=script.parent)
        assert r.returncode != 0 and r.stdout == ""


def test_kernel_build_is_content_addressed():
    names = {_build.library_path(n).name for n in _build.KERNELS}
    assert len(names) == len(_build.KERNELS)
    assert all(n.endswith(".so") and "-" in n for n in names)
    assert _build.BUILD_DIR == REPO / "build" / "repro_torch_kernels"
    assert "sm_90a" in _build.ARCH
