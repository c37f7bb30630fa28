"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``_build/<name>-<hash>.so`` beside the package, keyed by a hash of
its source, the shared headers ``csrc/*.cuh`` and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.  The
library is bound with ``ctypes``: no PyTorch headers are compiled, which
keeps a build to seconds.

The compiler is ``$CUDA_HOME/bin/nvcc`` when ``CUDA_HOME`` is set, else the
``nvcc`` on ``PATH``, else the toolkit's default install location.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a keeps the Hopper-only instructions (wgmma, setmaxnreg) available
# to later kernels.  No --use_fast_math: expf, rsqrtf and the divisions
# keep full float32 accuracy.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_BOUND: dict[str, set[str]] = {}  # entry points given their argtypes
# seconds spent compiling, per source, in this process (0.0 when loaded)
BUILD_SECONDS: dict[str, float] = {}
# per source compiled in this process, each kernel's resources as ptxas
# reports them: {mangled name: "Used N registers, ... spill ..."}
RESOURCES: dict[str, dict[str, str]] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def _digest(source: Path) -> str:
    """Hash of the source, the shared headers it may include, and the
    flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  Raises ``RuntimeError`` with the
    compiler's output when ``nvcc`` fails."""
    source = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{_digest(source)}.so"
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    BUILD_SECONDS[name] = time.perf_counter() - t0
    RESOURCES[name] = _ptxas_resources(proc.stdout + proc.stderr)
    return out


def _ptxas_resources(log: str) -> dict[str, str]:
    """Each entry function's "Used ... registers" and spill lines from
    ``-Xptxas -v`` output."""
    found: dict[str, str] = {}
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("spill" in line or "Used" in line):
            text = line.split(":", 1)[-1].strip()
            found[kernel] = f"{found[kernel]}; {text}" if kernel in found \
                else text
    return found


def build_all(names) -> None:
    """Compile the named sources side by side, one ``nvcc`` each, all
    started together; raises the first failure."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(build, name) for name in names]:
            fut.result()


def load(name: str, entry_points: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    ``entry_points`` maps each C function to its ``argtypes``; every one
    returns an ``int`` status (a ``cudaError_t``).  Several modules may
    bind functions of one source, each its own: a name not bound yet is
    bound on the first call that gives it.  Every source also exports
    ``const char* gpvae_cuda_error_string(int)``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.gpvae_cuda_error_string.restype = ctypes.c_char_p
            lib.gpvae_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
            _BOUND[name] = set()
        missing = entry_points.keys() - _BOUND[name]
        for fn_name in missing:
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = entry_points[fn_name]
        _BOUND[name] |= missing
        return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if status != 0:
        msg = lib.gpvae_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
