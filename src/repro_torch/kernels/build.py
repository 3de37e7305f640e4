"""Build and load the CUDA kernels (`csrc/*.cu`) for Hopper.

Each source is compiled by its own `nvcc` into a shared library with a
plain C interface (`-gencode arch=compute_90a,code=sm_90a`), all of them
started together, and loaded with `ctypes`. Nothing includes PyTorch's
headers, so a build takes seconds rather than minutes. Libraries go into
`build/kernels/` at the repository root, named by a hash of their
sources and flags, so a changed source is rebuilt and an unchanged one
is reused. The build runs at the first kernel launch, never at import.

Every C entry point launches on the stream it is given, does not
synchronise, and returns `cudaGetLastError()`; the wrappers raise when
that is not 0 (`check`). A wrapper launches on its operands' device
(`device_of` raises when they lie on more than one): `call` makes that
device current for the entry point — the runtime sets a kernel's
attributes (its shared-memory limit) and launches it on the current
device — and passes that device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

# one shared library per source; every .cu may include the csrc headers
SOURCES = ("search_step", "gather_l2", "rabitq_search_step", "topk",
           "pairwise_l2", "rabitq_distance", "gather_l2_tiled",
           "flash_attention", "flash_attention_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every missing library, one `nvcc` per source in parallel.
    Returns {name: library path}; raises with the compiler's output if any
    build fails. `ptxas` register/shared-memory reports are kept in
    `build/kernels/<name>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode})\n"
                          + out.decode(errors="replace"))
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (building all of them on first use)."""
    lib = _libs.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point `symbol` of library `name`, its argument types set
    (each pointer and the stream as c_void_p, or ctypes would pass them as
    32-bit ints and cut them) and an int return: the CUDA error code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_handle(device=None) -> int:
    """PyTorch's current CUDA stream of `device` (of the current device
    when None), as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def device_of(what: str, *tensors) -> torch.device:
    """The one device of a kernel's tensor operands (None skipped); raises
    when they lie on more than one."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: the operands lie on "
                         f"{sorted(map(str, devs))}, one device expected")
    return devs.pop()


def call(fn, device: torch.device, *args) -> int:
    """C entry point `fn` called with `device` current and that device's
    current stream after `args`; returns its CUDA error code."""
    with torch.cuda.device(device):
        return fn(*args, ctypes.c_void_p(stream_handle(device)))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's address as a C entry point takes it (an argument typed
    c_void_p; None is NULL)."""
    return t.data_ptr() if t is not None else None


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Argument checks shared by the wrappers: device, dtype, rank and
    contiguity — the kernels take raw pointers and trust all four."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
