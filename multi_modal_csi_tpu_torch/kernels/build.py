"""Build the CUDA sources under ``csrc/`` into shared libraries and load them
with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled alone with ``nvcc`` (no PyTorch headers, so a build takes seconds)
into ``_build/lib<name>-<hash>.so``, where the hash covers the source, every
``csrc/`` header it includes (``#include "x.cuh"``, followed through headers)
and the flags: an unchanged source is not rebuilt, a changed one or one
whose header changed never loads a stale library. The C++ window loader
(``data/native_loader.py``) builds with g++ into the same directory by the
same rule (``hashed_target``, ``compile_library``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources with many kernels, whose device code nvcc compiles in parallel
# threads (one a core): K4's 50 f32 instantiations and its bf16 kernels
SPLIT_COMPILE = {"flash_attention_lowrank_bwd"}

# compiler output (register and shared-memory use from ``-Xptxas -v``) of
# each library built by this process
LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly
    or through another header, each once, in the order first met."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def _flags(name: str) -> List[str]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (["--split-compile=0"] if name in SPLIT_COMPILE
                         else [])


def hashed_target(name: str, sources: List[Path], flags: List[str]) -> Path:
    """``_build/lib<name>-<hash>.so``, the hash over each source's name and
    bytes and the flags: the rule every library the port builds follows."""
    digest = hashlib.sha256()
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _target(name: str) -> Path:
    return hashed_target(name, _sources(name), _flags(name))


def _command(name: str, out: str) -> List[str]:
    """nvcc's argv building ``csrc/<name>.cu`` into ``out``; ``-I csrc``
    finds the shared headers."""
    return [_nvcc(), *_flags(name), "-I", str(CSRC), "-o", out,
            str(CSRC / f"{name}.cu")]


def compile_library(target: Path, command: Callable[[str], List[str]],
                    what: str) -> str:
    """Run ``command(tmp)``, which compiles into the file ``tmp``, and move
    the result to ``target`` (so a library another process is building is
    never loaded half written). Returns the compiler's output; raises
    RuntimeError with it when the compiler fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(command(tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{what} failed:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed. Each
    kernel module loads its library once and sets its C signatures."""
    target = _target(name)
    if not target.exists():
        LOGS[name] = compile_library(
            target, lambda out: _command(name, out), f"nvcc for {name}.cu")
    return ctypes.CDLL(str(target))
