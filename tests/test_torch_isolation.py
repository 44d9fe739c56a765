"""The port stands alone: no JAX, no ``tpuserve`` import anywhere in
``tpuserve_torch`` or ``chip_smoke.py``; no silent CPU fallback; the
kernel modules import on a machine without nvcc; and chip_smoke.py refuses
to report without a card or without the package."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
# the card-only kernel tests run where there is no JAX, so they stand alone too
PORT_FILES = sorted((ROOT / "tpuserve_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels.py"]
FORBIDDEN = ("jax", "jaxlib", "tpuserve")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_tpuserve(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code: str, cwd=ROOT, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_importing_the_engine_loads_no_jax():
    res = _run("import sys, tpuserve_torch.runtime.engine, tpuserve_torch.ops._build\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'tpuserve')]\n"
               "assert not bad, bad\n"
               "assert 'triton' not in sys.modules\n"
               "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_engine_without_device_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from tpuserve_torch.runtime import Engine, EngineConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(EngineConfig(model="tiny-qwen3"))


def test_kernel_modules_import_without_nvcc_and_build_nothing():
    """Importing the wrappers starts no build; without a CUDA toolkit the
    build itself raises instead of falling back."""
    from tpuserve_torch.ops import _build, flash_prefill, paged_decode
    assert flash_prefill.LAUNCHES >= 0 and paged_decode.LAUNCHES >= 0
    assert not _build._LIBS
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_decode")


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
