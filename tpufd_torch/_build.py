"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc, for ``sm_90a`` (Hopper), into
a shared library with a plain C interface: no PyTorch headers, so a build
takes seconds. Libraries are named by a hash of the source and the flags,
so an edited source never loads a stale library. They live in one
directory: ``$TPUFD_TORCH_KERNEL_DIR``, else ``build/torch_kernels/``
beside the package.

A checkout builds each library at first use. A node without the CUDA
toolkit, or with a read-only install, loads libraries built ahead into
that directory by

    TPUFD_TORCH_KERNEL_DIR=<dir> python -m tpufd_torch._build

``load`` opens a library that is there without starting nvcc and without
writing anything; one that is missing and cannot be built is a
RuntimeError naming the kernel, the library, the cause and that command.
Nothing is built when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
KERNEL_DIR_ENV = "TPUFD_TORCH_KERNEL_DIR"
BUILD_AHEAD = "python -m tpufd_torch._build"
KERNELS = ("dma_copy", "chain_tail", "chain_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries = {}


def _nvcc():
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def kernel_dir():
    """The library directory: $TPUFD_TORCH_KERNEL_DIR, else BUILD_DIR."""
    return Path(os.environ.get(KERNEL_DIR_ENV) or BUILD_DIR)


def library_path(name):
    """Where the library of kernel `name` lives, keyed on its source and
    the compiler flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return kernel_dir() / f"lib{name}-{key.hexdigest()[:16]}.so"


def nvcc_command(name, output):
    return [_nvcc(), *NVCC_FLAGS, "-o", str(output), str(CSRC / f"{name}.cu")]


def _cannot_build(name, cause):
    return RuntimeError(
        f"kernel {name!r}: library {library_path(name)} is missing and "
        f"cannot be built: {cause}. Build it ahead on a machine with the "
        f"CUDA toolkit (`{KERNEL_DIR_ENV}=<dir> {BUILD_AHEAD}`) and set "
        f"{KERNEL_DIR_ENV} to that directory")


def build(names=KERNELS):
    """Compiles every kernel of `names` whose library is missing, one nvcc
    per source, all started together. Returns {name: compiler output}
    (ptxas' register and shared-memory report) for what it built; raises
    RuntimeError naming each kernel that could not be built and why.
    Starts nothing and writes nothing when every library is there."""
    missing = [name for name in names if not library_path(name).exists()]
    if not missing:
        return {}
    directory = kernel_dir()
    jobs = {}
    try:
        for name in missing:
            target = library_path(name)
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            try:
                directory.mkdir(parents=True, exist_ok=True)
                tmp.touch()
            except OSError as e:
                raise _cannot_build(
                    name, f"cannot write the library directory {directory} "
                          f"({e})") from e
            command = nvcc_command(name, tmp)
            try:
                proc = subprocess.Popen(command, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT)
            except OSError as e:
                tmp.unlink(missing_ok=True)
                raise _cannot_build(
                    name, f"cannot run the CUDA compiler {command[0]} "
                          f"({e})") from e
            jobs[name] = (proc, tmp, target)
    except RuntimeError:
        for proc, tmp, _ in jobs.values():
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
        raise
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
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


def main():
    """Builds every kernel's library into kernel_dir(); prints one line
    per library, its name and path. Exits 1 if any cannot be built."""
    try:
        build()
    except RuntimeError as e:
        print(f"{BUILD_AHEAD}: {e}", file=sys.stderr)
        return 1
    for name in KERNELS:
        print(f"{name} {library_path(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
