"""Build and load the port's hand-written CUDA kernels.

Each `.cu` source under `weaviate_tpu_torch/csrc/` (with the `.cuh`
headers beside it) compiles with `nvcc` into a shared library with a
plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds). The build runs at first use, into
`build/kernels/` at the root of the checkout, under a name keyed by the
source's content and the flags, so an edited source rebuilds and an
unchanged one loads what is there. Nothing here runs at import: this
module imports on machines without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (build seconds, compiler output) of the builds this process ran
build_info: dict[str, tuple[float, str]] = {}


# The cudaError_t codes (CUDA 12 `driver_types.h`) that mean the card
# faulted at run time or is gone: an allocation that failed, a kernel that
# faulted (an illegal address or instruction, a trap, a device-side
# assert, a watchdog timeout) and left the context sticky, an uncorrectable
# ECC or NVLink error, a lost device. Every other code a C entry point
# returns is deterministic (an invalid value or configuration, a tensor map
# that does not encode, a launch asking for more resources than a block
# has): the same call fails the same way on a healthy card.
DEVICE_FAULT_CODES = frozenset({
    2,    # cudaErrorMemoryAllocation
    3,    # cudaErrorInitializationError
    46,   # cudaErrorDevicesUnavailable
    100,  # cudaErrorNoDevice
    214,  # cudaErrorECCUncorrectable
    220,  # cudaErrorNvlinkUncorrectable
    700,  # cudaErrorIllegalAddress
    702,  # cudaErrorLaunchTimeout
    709,  # cudaErrorContextIsDestroyed
    710,  # cudaErrorAssert
    714,  # cudaErrorHardwareStackError
    715,  # cudaErrorIllegalInstruction
    716,  # cudaErrorMisalignedAddress
    717,  # cudaErrorInvalidAddressSpace
    718,  # cudaErrorInvalidPc
    719,  # cudaErrorLaunchFailure
})


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's C entry point returned one of
    DEVICE_FAULT_CODES: the card faulted. It carries `device_error`, so
    `serving.robustness.is_device_error` counts it as a device fault and
    the shard's breaker trips on it."""

    device_error = True


class KernelCallError(RuntimeError):
    """A hand-written kernel's C entry point refused the call with a
    deterministic code (not in DEVICE_FAULT_CODES): a fault of the plan or
    the arguments, which the breaker must not hide behind the host plane.
    Neither is a failed build (RuntimeError from `build`) nor a bad shape
    (ValueError from the wrappers)."""


def launch_error(what: str, rc: int, text: str) -> RuntimeError:
    """The error a wrapper raises when its C entry point returns rc:
    KernelLaunchError for a card fault, KernelCallError otherwise."""
    cls = KernelLaunchError if rc in DEVICE_FAULT_CODES else KernelCallError
    return cls(f"{what}: {text} (cudaError_t {rc})")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if its keyed library is not built yet) and
    return the library's path. Concurrent builds each compile into a
    private temporary file and rename it into place."""
    src = CSRC / f"{name}.cu"
    # the key covers the shared headers too: an edit to the resident tile
    # rebuilds every kernel that includes it
    parts = [src.read_bytes()] + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    key = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
