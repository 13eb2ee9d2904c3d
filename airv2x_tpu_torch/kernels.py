"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

into ``airv2x_tpu_torch/build/`` (git-ignored) at first use, and is loaded
with ``ctypes``. The file name carries a hash of the source, so an edited
source is rebuilt. ``build_all`` starts one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code. ``LAUNCHES`` counts wrapper calls that launched a kernel:
the wrappers add one there and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures: every pointer and the stream are void*.
_SIGNATURES = {
    "pillar_encode": {
        # ids, feat, aux, params, maxbuf, sumbuf, out, m, n, cells, C, nx,
        # inv_nx, vsx, vsy, cx0, cy0, cz, out_bf16, stream
        "pillar_encode": [_P] * 7 + [_I] * 5 + [_F] * 6 + [_I, _P],
    },
    "quad_iou": {
        # rows (N, 8), cols (M, 8), out (N, M), N, M, triangular, stream
        "quad_iou": [_P, _P, _P, _I, _I, _I, _P],
    },
}

LAUNCHES = {name: 0 for name in _SIGNATURES}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{name}-{digest}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library is current; returns
    (process or None, target path, temporary path)."""
    target = _lib_path(name)
    if os.path.exists(target):
        return None, target, None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, os.path.join(CSRC, f"{name}.cu"),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def _finish_build(name: str, proc, target: str, tmp: str | None) -> str:
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    return out


def _load(name: str, target: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(target)
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all() -> dict[str, str]:
    """Build every kernel library in parallel and load it; returns the
    compiler's output (register and shared-memory use) per source."""
    started = {n: _start_build(n) for n in _SIGNATURES if n not in _LIBS}
    logs = {}
    for name, (proc, target, tmp) in started.items():
        logs[name] = _finish_build(name, proc, target, tmp)
        _load(name, target)
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        proc, target, tmp = _start_build(name)
        _finish_build(name, proc, target, tmp)
        _load(name, target)
    return _LIBS[name]


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
