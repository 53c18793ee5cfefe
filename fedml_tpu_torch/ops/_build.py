"""Build and load the port's CUDA kernels.

Every `fedml_tpu_torch/csrc/*.cu` is compiled by `nvcc` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) and loaded with `ctypes`. The wrappers pass
`tensor.data_ptr()` for every pointer and
`torch.cuda.current_stream().cuda_stream` for the stream; each C entry
point returns `cudaGetLastError()` after its launch.

Libraries go into `fedml_tpu_torch/_build/` (git-ignored), named by a hash
of every source under `csrc/` and the compiler flags, so an edited source
rebuilds and an unchanged one is reused. The build happens at first use;
`build_all()` starts one `nvcc` per source, all at once. Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _nvcc() -> str:
    # PyTorch's toolkit lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH,
    # then the toolkit's default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from fedml_tpu_torch/csrc at first use")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {source name: ptxas report}
    (registers, shared memory and spills per kernel) for those built now;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _sources():
        out = lib_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        reports[name] = text
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not lib_path(name).exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return lib

