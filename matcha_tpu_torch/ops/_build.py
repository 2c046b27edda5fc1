"""Build the native sources of `matcha_tpu_torch/csrc/` and load them with ctypes.

Each `csrc/<name>.cu` (a CUDA kernel, built by `nvcc`) or `csrc/<name>.cpp`
(host C++ with OpenMP, built by `g++`) has a plain C interface and compiles on
its own into `build/matcha_tpu_torch/lib<name>-<hash>.so` at the repository
root. The hash covers the source (with the `.cuh` headers for CUDA), the
compiler's flags and, for host C++, the target that `-march=native` resolves
to on this CPU: an edited source is never served from a stale library, and a
library built for one CPU is never loaded on another. No PyTorch headers are involved, so a build takes seconds.
Nothing is built at import time: a library is built at its first use, and
`build_all` builds every CUDA kernel at once, one `nvcc` process per source,
all in parallel.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "matcha_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
                       "matcha_tpu_torch CUDA kernels cannot be built")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host C++ sources of csrc/ cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def _cxx_target() -> bytes:
    """g++'s target options under CXX_FLAGS: the CPU `-march=native` resolves
    to here and the instruction sets it enables."""
    return subprocess.run([_cxx(), *CXX_FLAGS, "-Q", "--help=target"], capture_output=True,
                          check=True).stdout


def _source(name: str) -> Path:
    """`csrc/<name>.cu`, else `csrc/<name>.cpp`."""
    src = CSRC / f"{name}.cu"
    return src if src.exists() else CSRC / f"{name}.cpp"


def _lib_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes())
    if src.suffix == ".cu":  # the CUDA sources share the .cuh headers
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(CXX_FLAGS).encode())
        digest.update(_cxx_target())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(src: Path, out: Path) -> List[str]:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_cxx(), *CXX_FLAGS, "-o", str(out), str(src)]


def _start(name: str):
    """Start the compiler for one source: (process, tmp path, final path), or None if built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(_command(_source(name), tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the build of csrc/{_source(name).name} failed (exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file


def build_all() -> List[str]:
    """Compile every kernel that is not built yet, all nvcc processes at once."""
    with _lock:
        started = {n: _start(n) for n in kernel_names()}
        for name, s in started.items():
            if s is not None:
                _finish(name, s)
    return kernel_names()


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` or `.cpp`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
