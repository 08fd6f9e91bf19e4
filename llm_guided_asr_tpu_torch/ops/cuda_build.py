"""Build hand-written CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel source in ``llm_guided_asr_tpu_torch/csrc/`` exports plain C
functions (no PyTorch headers, so a build takes seconds, not minutes):

    int <name>(<pointers as void*>, <sizes as int>, ..., void* stream);
    const char* <prefix>_error_string(int code);

The launcher returns ``cudaGetLastError()``; :meth:`CudaKernel.launch` raises
when it is non-zero.  Libraries are built at first use into
``build/kernels/`` at the repository root, named by a hash of the source, the
headers it includes from its own directory (``#include "x.cuh"``, followed
recursively) and the flags, so that an edited source or header is never
served by a stale library.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


class CudaKernel:
    """One ``.cu`` source: its build, its C entry points and their launch counts.

    ``launches[name]`` counts the calls of the C entry point ``name`` made
    through :meth:`launch` that the card accepted, and nothing else, so a
    caller can show that a path went through each kernel;
    ``dtype_launches[name]`` splits them by the operands' dtype where the
    wrapper names it (``{"torch.bfloat16": n, ...}``).
    """

    def __init__(self, source: str, functions: Dict[str, Sequence], error_fn: str,
                 queries: Optional[Dict[str, Sequence]] = None):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)  # C name -> ctypes argtypes
        self.queries = dict(queries or {})  # C functions that launch nothing: name -> argtypes
        self.error_fn = error_fn
        self.launches: Dict[str, int] = dict.fromkeys(self.functions, 0)
        self.dtype_launches: Dict[str, Dict[str, int]] = {name: {} for name in self.functions}
        self.ptxas_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    # -- build -----------------------------------------------------------
    def sources(self) -> List[Path]:
        """The source and every header it includes with quotes from its own
        directory, transitively, in the order first met."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop(0)
            if path in found:
                continue
            found.append(path)
            for name in _INCLUDE.findall(path.read_text()):
                header = path.parent / name
                if header.is_file():
                    todo.append(header)
        return found

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for path in self.sources():
            h.update(path.name.encode() + b"\0" + path.read_bytes())
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
            for name, argtypes in {**self.functions, **self.queries}.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = getattr(lib, self.error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, function: str, *args, dtype=None) -> None:
        lib = self._load()
        code = getattr(lib, function)(*args)
        if code != 0:
            msg = getattr(lib, self.error_fn)(code).decode()
            raise RuntimeError(f"{function} launch failed: CUDA error {code} ({msg})")
        self.launches[function] += 1
        if dtype is not None:
            by_dtype = self.dtype_launches[function]
            by_dtype[str(dtype)] = by_dtype.get(str(dtype), 0) + 1

    def query(self, function: str, *args) -> int:
        """The int a query function returns; it launches nothing and is not
        counted."""
        return getattr(self._load(), function)(*args)

    def reset_launches(self) -> None:
        self.launches = dict.fromkeys(self.functions, 0)
        self.dtype_launches = {name: {} for name in self.functions}

