"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``*.cu`` file under ``repro_torch/kernels`` is compiled by ``nvcc`` for
``sm_90a`` into an object file (one ``nvcc`` per source, all started
together), and the objects are linked into one shared library under
``build/repro_torch_kernels/`` at the repository root.  The library's name
carries a hash of the sources and flags, so an edit to any source rebuilds
it and an unchanged tree reuses it.  The sources expose plain C entry points
that take pointers and the stream as ``void*`` and return a ``cudaError_t``.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional

PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = PKG.parents[2] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

#: C signatures of the entry points, (argtypes, restype).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "repro_flash_attention_f32": ([_P] * 5 + [_I] * 7 + [_F, _P], _I),
    "repro_flash_attention_bf16": ([_P] * 5 + [_I] * 7 + [_F, _P], _I),
    "repro_flash_attention_bwd": ([_P] * 11 + [_I] * 8 + [_F, _P], _I),
    "repro_flash_attention_bwd_bf16": ([_P] * 11 + [_I] * 8 + [_F, _P], _I),
    "repro_decode_attention": ([_P] * 7 + [_I] * 5 + [_L] * 3 + [_I, _F, _P], _I),
    "repro_decode_attention_int8": ([_P] * 9 + [_I] * 5 + [_L] * 3 + [_I, _F, _P], _I),
    "repro_decode_attention_chunk": ([_I, _I], _I),
    "repro_ddim_step_f32": ([_P, _P, _P, ctypes.c_int64, _F, _F, _P], _I),
    "repro_wkv6": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "repro_wkv6_bwd": ([_P] * 16 + [_I] * 5 + [_P], _I),
    "repro_wkv6_bwd_occupancy": ([_I, _I, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(PKG.rglob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sources() + sorted(PKG.rglob("*.cuh")):
        h.update(str(p.relative_to(PKG)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> pathlib.Path:
    """Compile (if the sources changed) and return the library's path.  The
    compiler's register and shared-memory report lands in ``ptxas.log``
    beside it."""
    lib_path = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outs = [(src, proc.communicate()[0], proc.returncode)
                for src, proc in procs]  # wait for every compiler first
        for src, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        log = [f"== {src.relative_to(PKG)}\n{out}" for src, out, _ in outs]
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                        *map(str, objs)], check=True)
        (BUILD_DIR / "ptxas.log").write_text("".join(log))
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """A kernel without a backward refuses inputs that need a gradient while
    grad mode is on: its result, filled through ctypes, would carry no
    ``grad_fn``, and everything before it would train on a silently missing
    gradient.  Serving runs without grad and is never refused."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward kernel: its inputs need a "
                           f"gradient, which the CUDA kernel cannot give")


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (the dry-run traces on them): it has a
    device but no data, and goes through a kernel's custom op, whose fake
    implementation gives its output's shape."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def entry(op, impl, t):
    """What a wrapper calls for a kernel on ``t``: its custom op ``op`` where
    ``t`` is fake or a dispatch mode is active (the dry-run's fake mode, a
    flop or collective counter), which must see the op whole; else the op's
    own body ``impl``, directly, since the op's dispatch costs tens of
    microseconds of host time a call."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return op if is_fake(t) or _get_current_dispatch_mode() is not None else impl


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; stage threads launch concurrently."""
    with _count_lock:
        wrapper.launches += 1
