"""Build the port's CUDA sources, load them with ``ctypes``, launch their
kernels and count the launches.

Each ``primia_tpu_torch/csrc/<name>.cu`` is compiled on first use by
``nvcc`` into ``build/primia_tpu_torch/lib<name>-<hash>.so`` at the root
of the checkout (the hash covers the source and the flags, so an edited
source is rebuilt), as a shared library with a plain C interface. Its
launchers take device pointers and PyTorch's current stream as integers
and return ``cudaGetLastError()``; ``<name>_error_string`` names a code.
Nothing is compiled or loaded when a module is imported: a CPU-only host
never needs ``nvcc``.

A kernel wrapper (``ops/cuda_*.py``) declares its library's C interface
once, at import, with :func:`declare`, and calls it through
:func:`launch` (a kernel, on PyTorch's current stream) or :func:`query`
(an occupancy question). :data:`launches` counts each declared
launcher's launches in this process; :func:`read_launches` and
:func:`reset_launches` read and clear it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "primia_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

# the kernel wrappers, one a library: read_launches imports them so that
# every launcher is declared
WRAPPERS = ("cuda_clahe", "cuda_tent", "cuda_dcf", "cuda_wgrad", "cuda_bn", "cuda_kernels",
            "cuda_attention")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_signatures: Dict[str, Dict[str, tuple]] = {}  # library -> {function: (argtypes, restype)}
launches: Dict[str, int] = {}  # launcher -> launches that returned 0


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
    """The built library for ``csrc/<name>.cu`` with its declared C
    signatures, compiling it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (argtypes, restype) in _signatures.get(name, {}).items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, restype
            _loaded[name] = lib
        return lib


def declare(name: str, launchers: Dict[str, List], *, uncounted: Sequence[str] = (),
            queries: Optional[Dict[str, List]] = None) -> None:
    """Declares ``csrc/<name>.cu``'s C interface, set on the library when
    it is loaded: each launcher's argument types before the stream (it
    takes the stream last and returns a CUDA error code), each query's
    argument types (it returns an int), and ``<name>_error_string``.
    Every launcher but those in ``uncounted`` joins :data:`launches` at 0."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    sigs = {f"{name}_error_string": ([ci], ctypes.c_char_p)}
    sigs.update({fn: ([*args, vp], ci) for fn, args in launchers.items()})
    sigs.update({fn: (list(args), ci) for fn, args in (queries or {}).items()})
    _signatures[name] = sigs
    for fn in launchers:
        if fn not in uncounted:
            launches.setdefault(fn, 0)


def _call(name: str, fn: str, device: torch.device, args) -> int:
    """``fn`` of library ``name`` on ``device``: the current device is
    switched only where it is another."""
    f = getattr(load_library(name), fn)
    if device.index == torch.cuda.current_device():
        return f(*args)
    with torch.cuda.device(device):
        return f(*args)


def _raise(name: str, fn: str, err: int) -> None:
    text = getattr(load_library(name), f"{name}_error_string")(err).decode()
    raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({text})")


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Launches ``fn`` of library ``name`` with ``args`` on PyTorch's
    current stream of ``device`` (a CUDA tensor's). The raw stream handle,
    and no device context where ``device`` is the current one, cost far
    less host time than stream and context objects: a batch norm launches
    six times a step for each of 20 layers. Raises on a non-zero return;
    counts a declared launcher's launch in :data:`launches` after a 0."""
    err = _call(name, fn, device, (*args, torch._C._cuda_getCurrentRawStream(device.index)))
    if err != 0:
        _raise(name, fn, err)
    if fn in launches:
        launches[fn] += 1


def query(name: str, fn: str, device: torch.device, *args) -> int:
    """The positive answer of query ``fn`` of library ``name`` on
    ``device``; raises where it returns a negated CUDA error code (or 0)."""
    n = _call(name, fn, device, args)
    if n <= 0:
        _raise(name, fn, -n)
    return n


def on_card(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` takes the kernel: False for a CPU tensor (the plain
    version runs), True for a CUDA one; raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CPU or CUDA tensors, not {t.device}")
    return True


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` (the current one where it has no
    index)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def reset_launches() -> None:
    for fn in launches:
        launches[fn] = 0


def read_launches() -> Dict[str, int]:
    """Every launcher of the port's libraries with its launches since the
    last :func:`reset_launches`, 0 where it has none."""
    for module in WRAPPERS:
        importlib.import_module(f"primia_tpu_torch.ops.{module}")
    return dict(launches)
