"""One kernel policy and one build for every hand-written Hopper kernel.

The policy (the counterpart of ``repro/kernels/backend.py``) is decided
by the tensor's device:

  * a CPU tensor takes the kernel's plain PyTorch version; demanding the
    kernel there (a wrapper's ``use_kernel=True``) raises;
  * a ``meta`` tensor (the dry run's: shapes without data) takes the
    plain version too, and demanding the kernel there raises;
  * a CUDA tensor on an sm_90 card takes the compiled kernel, and a card
    of any other capability raises instead of running something else.

The build: a ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, under
``build/repro_torch/`` of the checkout, and loaded with ``ctypes``. The
library's name carries a hash of its source and flags, so an edited
source is never served from a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

REQUIRED_CAPABILITY = (9, 0)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_CAPABILITY: dict = {}    # CUDA device -> its capability, read once


def use_kernel(t: torch.Tensor, require: bool = False) -> bool:
    """True when a wrapper given ``t`` launches its compiled kernel, False
    when it takes the plain version. ``require=True`` (a wrapper's
    ``use_kernel=True``) demands the kernel and raises on a CPU or a
    ``meta`` tensor."""
    if t.device.type in ("cpu", "meta"):
        if require:
            raise ValueError("use_kernel=True needs a CUDA tensor: the "
                             "compiled kernels run only on the card")
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel policy for device {t.device}")
    cap = _CAPABILITY.get(t.device)
    if cap is None:
        cap = _CAPABILITY[t.device] = torch.cuda.get_device_capability(
            t.device)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} is sm_{cap[0]}{cap[1]}")
    return True


@dataclass(frozen=True)
class Built:
    """A compiled kernel library: its path, nvcc's output (the
    ``-Xptxas -v`` register and shared-memory report) and the seconds
    the compile took (empty and 0.0 when an existing build was reused)."""
    path: Path
    log: str
    seconds: float


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): nvcc is "
                           "needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source) -> Built:
    """Compile ``source`` unless it is built already. Raises with nvcc's
    output when the compile fails."""
    source = Path(source)
    so = _target(source)
    if so.exists():
        return Built(so, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)
    return Built(so, proc.stdout, time.perf_counter() - t0)


_LOADED: dict[Path, ctypes.CDLL] = {}


def load(source) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is None:
        lib = _LOADED[source] = ctypes.CDLL(str(build(source).path))
    return lib
