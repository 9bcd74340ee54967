"""Build and load the port's CUDA kernels and its host libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into ``build/models_tpu_torch/`` at the root of the
checkout, under a name that carries a hash of the source and of every header
in ``csrc/`` (which the sources include from there), then loaded with
``ctypes``. The host libraries, ``csrc/host/<name>.cc`` (the parquet codec's
loops and the native batcher), are built the same way by ``g++ -O3 -shared
-fPIC``, named by a hash of their source. Nothing is compiled or loaded when
this module is imported. The build holds a file lock in that directory, so
that the ranks of a run on one host compile each library once between them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "models_tpu_torch"
SOURCES = ("streaming_topk", "binned_rescore", "bin_max", "flash_ce", "row_scatter",
           "row_gather")
HOST = CSRC / "host"
HOST_SOURCES = ("parquet_codec", "fastbatch")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # ptxas report of each library built here


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _gxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("g++ not found: the host libraries build with a C++ compiler")
    return found


def _target(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """The library of ``<csrc>/<name>.cu``, named by a hash of its source and
    of the headers beside it: an edit to either builds it anew. A host
    library, ``<csrc>/host/<name>.cc``, by a hash of its source."""
    if name in HOST_SOURCES:
        h = hashlib.sha1((csrc / "host" / f"{name}.cc").read_bytes())
        return build_dir / f"lib{name}-{h.hexdigest()[:12]}.so"
    h = hashlib.sha1((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return build_dir / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> List[str]:
    if name in HOST_SOURCES:
        return [_gxx(), *GXX_FLAGS, "-o", str(out), str(HOST / f"{name}.cc")]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = SOURCES + HOST_SOURCES) -> List[Path]:
    """Compile the named sources that are not built yet, one compiler each
    (``nvcc`` for a kernel, ``g++`` for a host library), all started
    together. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return _build_locked(list(names))


def _build_locked(names: List[str]) -> List[Path]:
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return [_target(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of the host source
    ``csrc/host/<name>.cc``), built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            if name not in HOST_SOURCES:
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
