"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. All sources are
compiled at once, one ``nvcc`` process each, into
``supertonic_tpu_torch/build/<hash>/``, where the hash covers the sources
and the flags, so an edited kernel is rebuilt and an unchanged one is
loaded as built. Nothing here runs at import time: the first launch (or an
explicit ``build_all()``) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "build"
KERNELS = ("attention", "ffn", "resblock_chain", "int8_matmul", "quantize", "ln_modulate",
           "rope", "gated_residual", "conv1d", "linear")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
# the first launch from several threads at once (the batcher's and a
# streaming handler's) must build and load each library once
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from supertonic_tpu_torch/csrc at first use")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(*, verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel library that is not built yet, all in parallel.
    Returns {kernel name: library path}. Raises with nvcc's output on a
    failed build."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in KERNELS}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        # pid and thread: processes sharing the checkout, and threads
        # sharing a pid, never write one temporary file
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def function(kernel: str, name: str, argtypes):
    """The C entry ``name`` of one kernel's library, with its argument types
    declared (it returns a CUDA error code); builds on first use."""
    fn = _fns.get((kernel, name))
    if fn is None:
        with _lock:
            fn = _fns.get((kernel, name))
            if fn is None:
                lib = _libs.get(kernel)
                if lib is None:
                    lib = _libs[kernel] = ctypes.CDLL(str(build_all()[kernel]))
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[(kernel, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on(t):
    """``t``'s device as the current one around a launch: a kernel runs on
    the current device, whose stream ``stream_ptr`` must be, and its
    one-time attributes are set per device."""
    import torch

    return torch.cuda.device(t.device)


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def dtype_code(dtype) -> int:
    """0 = float32, 1 = bfloat16 (the kernels' storage types)."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
