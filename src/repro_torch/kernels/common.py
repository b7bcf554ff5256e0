"""Helpers shared by every kernel family of the port.

* `resolve_device`: the device rule of every entry point.
* `build_library` / `build_libraries`: the one ``nvcc`` builder.  Each
  family's ``csrc/*.cu`` is compiled for ``sm_90a`` into a shared library
  with a plain C interface, ``build/lib<name>-<tag>.so`` at the repository
  root, where the tag hashes the source and the flags: an edited source is
  rebuilt, an unchanged one reused.  The compiler's output is kept beside
  it (``.log``).  The families load it with ctypes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["resolve_device", "build_library", "build_libraries", "BUILD_DIR",
           "BUILD_LOGS", "NVCC_FLAGS"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# name -> the compiler's output of the build that made the loaded library
# (``-Xptxas -v``: registers, shared memory and spills per kernel), read
# back from its ``.log`` when the library is reused
BUILD_LOGS: dict[str, str] = {}


def resolve_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means the CUDA device: the port runs on the card unless the
    caller asks for another device by name.  There is no auto-detection,
    so a machine without CUDA raises here instead of quietly running on
    the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def _lib_path(name: str, source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_libraries(specs: dict[str, Path]) -> dict[str, Path]:
    """Build every library of ``{name: source}`` that is missing, all at once.

    One ``nvcc`` per source, started together and then awaited, so the
    build takes as long as the slowest source.  Returns ``{name: path}``.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    paths = {name: _lib_path(name, Path(src)) for name, src in specs.items()}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            log = path.with_suffix(".log")
            if log.exists():
                BUILD_LOGS[name] = log.read_text()
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(specs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {Path(specs[name]).name}:\n"
                          f"{BUILD_LOGS[name]}")
        else:
            paths[name].with_suffix(".log").write_text(BUILD_LOGS[name])
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_library(name: str, source: Path) -> Path:
    """Build ``source`` into ``build/lib<name>-<tag>.so`` if it is missing."""
    return build_libraries({name: source})[name]
