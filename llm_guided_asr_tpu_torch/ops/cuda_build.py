"""Build hand-written CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel source in ``llm_guided_asr_tpu_torch/csrc/`` exports plain C
functions (no PyTorch headers, so a build takes seconds, not minutes):

    int <name>(<pointers as void*>, <sizes as int>, ..., void* stream);
    const char* <prefix>_error_string(int code);

The launcher returns ``cudaGetLastError()``; :meth:`CudaKernel.launch` raises
when it is non-zero.  Libraries are built at first use into
``build/kernels/`` at the repository root, named by a hash of the source and
the flags so that an edited source is never served by a stale library.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


class CudaKernel:
    """One ``.cu`` source: its build, its C entry points and a launch count.

    ``launches`` counts the kernel launches made through :meth:`launch` and
    nothing else, so a caller can show that a path went through the kernel.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence], error_fn: str):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)  # C name -> ctypes argtypes
        self.error_fn = error_fn
        self.launches = 0
        self.ptxas_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    # -- build -----------------------------------------------------------
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build_command(self, out: Path) -> List[str]:
        return [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v",
                "-o", str(out), str(self.source)]

    def build(self) -> None:
        """Compile the source with ``nvcc`` unless its library exists.

        ``nvcc`` writes a per-process temporary file that is renamed into
        place, so a concurrent loader sees the whole library or none.
        """
        out = self.library_path()
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(self.build_command(tmp), capture_output=True, text=True)
        self.ptxas_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.ptxas_log}")
        os.replace(tmp, out)

    # -- load and launch -------------------------------------------------
    def _load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.library_path()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = getattr(lib, self.error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, function: str, *args) -> None:
        lib = self._load()
        code = getattr(lib, function)(*args)
        if code != 0:
            msg = getattr(lib, self.error_fn)(code).decode()
            raise RuntimeError(f"{function} launch failed: CUDA error {code} ({msg})")
        self.launches += 1

