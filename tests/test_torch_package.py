"""Packaging rules of the port: no JAX, the kernel is built for Hopper into
an ignored directory, and CUDA-only entry points never run on the CPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ccqppy_tpu_torch.ops import kernels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _run(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_no_jax():
    proc = _run(["-c", "import sys, ccqppy_tpu_torch, ccqppy_tpu_torch.utils.convert, "
                       "ccqppy_tpu_torch.entry, ccqppy_tpu_torch.compat, "
                       "ccqppy_tpu_torch.utils.problems, ccqppy_tpu_torch.utils.diagnostics, "
                       "ccqppy_tpu_torch.utils.plotting; "
                       "from ccqppy_tpu_torch.utils import (BenchmarkRandomCCQP, BenchmarkResult, "
                       "default_families, disjoint_families); "
                       "assert 'matplotlib' not in sys.modules; "
                       "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
                       "or m.startswith('ccqppy_tpu.') or m == 'ccqppy_tpu']; "
                       "assert not bad, bad"], ROOT)
    assert proc.returncode == 0, proc.stderr


def test_build_targets_sm_90a_from_repo_sources():
    cmd = kernels.nvcc_command("out.so", kernels.sources())
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert [Path(s).name for s in cmd if s.endswith(".cu")] == [
        "batched_gemv.cu", "batched_symv.cu"]
    assert all(Path(s).is_relative_to(ROOT / "ccqppy_tpu_torch" / "csrc")
               for s in cmd if s.endswith(".cu"))


def test_build_directory_is_ignored():
    rel = kernels.BUILD_DIR.relative_to(ROOT)
    ignored = {line.strip() for line in (ROOT / ".gitignore").read_text().splitlines()}
    assert f"{rel.parts[0]}/" in ignored
    assert kernels.library_path(kernels.sources()).parent == kernels.BUILD_DIR


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = kernels.library_path([src])
    src.write_text("// two\n")
    assert kernels.library_path([src]) != first


def test_cuda_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
    # Alone in a directory, without the package beside it, the script fails.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros((1, 4, 4), device="cuda")
