"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
into its own shared library for ``sm_90a``; sources may include the
package's ``*.cuh`` headers.  Libraries go to ``build/repro_torch/`` at the
root of the checkout, named by a hash of the source, the headers and the
flags, so an edit rebuilds and an unchanged source is built once.
``nvcc -Xptxas -v`` prints each kernel's registers, shared memory and
spills; that report is kept beside the library as ``<name>.log``.

Only a wrapper's CUDA branch imports this module, so code that runs on the
CPU never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from ..errors import KernelError

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

#: kernel name -> its source, relative to this package
SOURCES = {
    "or_and_matmul": "bool_matmul/csrc/or_and_matmul.cu",
    "or_and_skinny": "bool_matmul/csrc/or_and_skinny.cu",
    "min_plus_matmul": "tropical_matmul/csrc/min_plus_matmul.cu",
    "bitpack_matmul": "bitpack_ops/csrc/bitpack_matmul.cu",
    "local_eval": "local_eval/csrc/local_eval.cu",
    # throughput probe behind the min-plus bound (chip_smoke.py); no query
    # path calls it
    "dpx_rate": "tropical_matmul/csrc/dpx_rate.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# held by a build, and by the first load of each library, so that threads
# that launch kernels at once build and load every library once
_lock = threading.RLock()
_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when none has it."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise KernelError("nvcc not found in $CUDA_HOME/bin, on PATH or in "
                       "/usr/local/cuda/bin; the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built."""
    digest = hashlib.sha256((_KERNELS / SOURCES[name]).read_bytes())
    for header in sorted(_KERNELS.rglob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns the
    library paths; raises with the compiler's output if a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {name: _library_path(name) for name in names}
        procs = {}
        for name, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_KERNELS / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            paths[name].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, paths[name])
        if failed:
            raise KernelError("kernel build failed: " + "\n".join(failed))
        return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use; safe to
    call from several threads at once."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libraries[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise KernelError(f"{name} launch failed: CUDA error {code} ({msg})")
