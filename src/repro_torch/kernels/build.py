"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, one ``nvcc`` per source, all
started together, into ``build/repro_torch_kernels/`` under the repository
root; a library's file name carries a hash of its source and flags, so an
edited source is rebuilt.  The libraries are loaded with ``ctypes``;
nothing here includes PyTorch's headers.  Building happens at first use,
never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all(verbose: bool = False) -> dict[str, pathlib.Path]:
    """Compile every out-of-date source, all ``nvcc`` processes at once;
    returns ``{source stem: library path}``.  Raises with the compiler's
    output if any build fails."""
    srcs = sorted(CSRC.glob("*.cu"))
    out = {s.stem: _target(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for s in todo:
            tmp = out[s.stem].with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for s, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{s.name}:\n{log}")
                continue
            if verbose and log:
                print(log)
            os.replace(tmp, out[s.stem])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built first if
    needed)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            _LIBS[stem] = lib
        return lib
