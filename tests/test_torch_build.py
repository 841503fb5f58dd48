"""Where the port's kernel libraries come from: built at first use, built
ahead by ``python -m tpufd_torch._build`` into $TPUFD_TORCH_KERNEL_DIR,
and loaded from there without a compiler. A library that is missing and
cannot be built is a RuntimeError naming the kernel, the library, the
cause and the build-ahead command, never a bare OSError.

This host has no nvcc. A stand-in compiler (a shell script that links an
empty shared library with the host's cc at nvcc's -o path) drives the
build-ahead path end to end."""

import os
import stat
import subprocess
import sys

import pytest

from conftest import REPO
from tpufd_torch import _build

FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: links an empty shared library at the -o path.
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then out=$2; fi
  shift
done
exec cc -shared -fPIC -o "$out" -x c /dev/null
"""


@pytest.fixture
def kernel_dir(tmp_path, monkeypatch):
    """A fresh library directory in TPUFD_TORCH_KERNEL_DIR, with no
    library loaded yet in this process."""
    directory = tmp_path / "kernels"
    monkeypatch.setenv(_build.KERNEL_DIR_ENV, str(directory))
    monkeypatch.setattr(_build, "_libraries", {})
    return directory


@pytest.fixture
def fake_nvcc(tmp_path):
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text(FAKE_NVCC)
    path.chmod(0o755)
    return path


def listing(directory):
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in directory.iterdir())


def no_compiler(*args, **kwargs):
    raise AssertionError(f"a compiler was started: {args}")


def test_kernel_dir_follows_the_setting(kernel_dir, monkeypatch):
    assert _build.kernel_dir() == kernel_dir
    assert _build.library_path("dma_copy").parent == kernel_dir
    monkeypatch.delenv(_build.KERNEL_DIR_ENV)
    assert _build.kernel_dir() == _build.BUILD_DIR


@pytest.mark.parametrize("name", _build.KERNELS)
def test_missing_compiler_is_named(kernel_dir, tmp_path, monkeypatch, name):
    nvcc = tmp_path / "no-toolkit" / "nvcc"
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError) as error:
        _build.load(name)
    text = str(error.value)
    assert f"kernel {name!r}" in text
    assert str(_build.library_path(name)) in text
    assert f"cannot run the CUDA compiler {nvcc}" in text
    assert "python -m tpufd_torch._build" in text
    assert name not in _build._libraries
    # Nothing half-built is left behind.
    assert listing(kernel_dir) == []


@pytest.mark.parametrize("name", _build.KERNELS)
def test_unwritable_directory_is_named(tmp_path, monkeypatch, name):
    """The library directory lies under a regular file, so it can be
    neither created nor written (a chmod proves nothing to root)."""
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    directory = blocker / "kernels"
    monkeypatch.setenv(_build.KERNEL_DIR_ENV, str(directory))
    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build.subprocess, "Popen", no_compiler)
    with pytest.raises(RuntimeError) as error:
        _build.load(name)
    text = str(error.value)
    assert f"kernel {name!r}" in text
    assert str(_build.library_path(name)) in text
    assert f"cannot write the library directory {directory}" in text
    assert "python -m tpufd_torch._build" in text


def test_prebuilt_library_loads_without_a_compiler_or_a_write(kernel_dir):
    """Libraries named by library_path in the directory load with every
    compiler start failing, and the directory is left as it was."""
    kernel_dir.mkdir()
    for name in _build.KERNELS:
        subprocess.run(["cc", "-shared", "-fPIC", "-o",
                        str(_build.library_path(name)), "-x", "c",
                        "/dev/null"], check=True)
    kernel_dir.chmod(stat.S_IRUSR | stat.S_IXUSR)
    before = listing(kernel_dir)
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(_build.subprocess, "Popen", no_compiler)
            patch.setattr(_build, "_nvcc", no_compiler)
            libraries = [_build.load(name) for name in _build.KERNELS]
    finally:
        kernel_dir.chmod(0o755)
    assert [lib._name for lib in libraries] == [
        str(_build.library_path(name)) for name in _build.KERNELS]
    assert _build.load("dma_copy") is libraries[0]
    assert listing(kernel_dir) == before


def test_build_ahead_fills_the_directory_then_loads(kernel_dir, fake_nvcc,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake_nvcc))
    assert _build.main() == 0
    assert capsys.readouterr().out.splitlines() == [
        f"{name} {_build.library_path(name)}" for name in _build.KERNELS]
    assert sorted(p.name for p in kernel_dir.iterdir()) == sorted(
        _build.library_path(name).name for name in _build.KERNELS)
    before = listing(kernel_dir)
    # Built once: a second run and every load start no compiler.
    monkeypatch.setattr(_build.subprocess, "Popen", no_compiler)
    assert _build.main() == 0
    for name in _build.KERNELS:
        _build.load(name)
    assert listing(kernel_dir) == before


def test_failed_compile_leaves_no_library(kernel_dir, tmp_path, monkeypatch):
    broken = tmp_path / "broken-nvcc"
    broken.write_text("#!/bin/sh\necho 'error: no sm_90a here'\nexit 2\n")
    broken.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(broken))
    with pytest.raises(RuntimeError, match=r"(?s)kernel build failed: "
                       r"dma_copy \(nvcc exit 2\):.*no sm_90a here"):
        _build.load("dma_copy")
    assert listing(kernel_dir) == []


def run_build_ahead(path_dirs, kernel_dir):
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "PATH": os.pathsep.join(map(str, path_dirs)),
           _build.KERNEL_DIR_ENV: str(kernel_dir)}
    return subprocess.run([sys.executable, "-m", "tpufd_torch._build"],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)


def test_build_ahead_command_without_nvcc_fails_naming_it(tmp_path):
    proc = run_build_ahead(["/usr/bin", "/bin"], tmp_path / "kernels")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "cannot run the CUDA compiler /usr/local/cuda/bin/nvcc" in (
        proc.stderr)
    assert "python -m tpufd_torch._build" in proc.stderr


def test_build_ahead_command_takes_nvcc_from_path(tmp_path, fake_nvcc):
    directory = tmp_path / "kernels"
    proc = run_build_ahead([fake_nvcc.parent, "/usr/bin", "/bin"], directory)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [line.split()[0] for line in lines] == list(_build.KERNELS)
    for line in lines:
        name, path = line.split()
        assert path.startswith(f"{directory}/lib{name}-")
        assert os.path.getsize(path) > 0
