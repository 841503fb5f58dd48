"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc, for ``sm_90a`` (Hopper), into
a shared library with a plain C interface: no PyTorch headers, so a build
takes seconds. Libraries go to ``build/torch_kernels/`` beside the
package, named by a hash of the source and the flags, so a checkout
builds at first use and an edited source never loads a stale library.
Nothing is built when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
KERNELS = ("dma_copy",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries = {}


def _nvcc():
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name):
    """Where the library of kernel `name` lives, keyed on its source and
    the compiler flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def nvcc_command(name, output):
    return [_nvcc(), *NVCC_FLAGS, "-o", str(output), str(CSRC / f"{name}.cu")]


def build(names=KERNELS):
    """Compiles every kernel of `names` whose library is missing, one nvcc
    per source, all started together. Returns {name: compiler output}
    (ptxas' register and shared-memory report) for what it built; raises
    RuntimeError naming every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(nvcc_command(name, tmp), text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name):
    """The ctypes library of kernel `name`, built first if missing."""
    lib = _libraries.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _libraries[name] = lib
    return lib
