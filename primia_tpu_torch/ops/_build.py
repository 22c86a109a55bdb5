"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``primia_tpu_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` into ``build/primia_tpu_torch/lib<name>-<hash>.so`` at the root
of the checkout (the hash covers the source and the flags, so an edited
source is rebuilt), as a shared library with a plain C interface. Its
launchers take device pointers and PyTorch's current stream as integers
and return ``cudaGetLastError()``. Nothing is compiled when a module is
imported: a CPU-only host never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "primia_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels are compiled at first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def source_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` per source, all started together.
    Returns ``{name: library path}``; raises with nvcc's output if any
    compile fails."""
    names = list(source_names() if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    try:
        for n in todo:
            tmp = paths[n].with_name(f"{paths[n].stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[n] = (proc, tmp)
        failures = []
        for n, (proc, tmp) in jobs.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiling it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
