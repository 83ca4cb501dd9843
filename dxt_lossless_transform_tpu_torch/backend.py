"""Device selection, the CUDA kernel library, host<->device copies and launch counts.

The kernels live in the CUDA C++ sources ``csrc/*.cu`` (``bc1_kernels.cu`` with the
LTU count kernel in its three forms, ``bc2_kernels.cu``, ``bc3_kernels.cu``, ``bc45_kernels.cu``,
``bc7_kernels.cu`` with the BC7/BC6H mode sort, ``rgb_kernels.cu`` with the RGB
channel split and merge, ``words_kernels.cu`` with the word deinterleave of the
batch pipeline), which share ``csrc/common.cuh`` and have plain
``extern "C"`` entry points. At first use, :func:`library` compiles all of them
with one ``nvcc`` call into one shared library under ``build/cuda/`` at the
repository root and loads it with :mod:`ctypes`. The file name carries a hash of
every source and header and of the flags, and the library is written under a
temporary name unique to the process and the thread and renamed into place, so that
processes building at the same time cannot see a half-written file; within a process
one lock covers the check, the build and the load, so that threads that reach the
library at once run one ``nvcc``. Nothing is built or loaded when the package is
imported.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises :class:`KernelLaunchError` when that
is not 0 and otherwise adds one to the kernel's count in :data:`LAUNCHES`, under a
lock, since the CLI launches from several threads.

Beside it, :func:`count` adds to the program's other counters, always on and under
the same lock: ``batch.blocks_real`` and ``batch.blocks_launched`` (the payloads'
blocks and the bucket-padded rows that ``BatchProcessor`` launched), and
``batch.files_device_bytes`` (the files whose shipped bytes the card wrote: the
device-scored ``BatchProcessor``'s non-empty files), and the host copier's
``batch.copy_bytes_parallel``, ``batch.copy_bytes_serial`` and ``batch.copy_threads``
(:mod:`.parallel.host_copy`; the last is set, by :func:`set_count`, not summed).
:func:`counters` snapshots them as plain ints, with ``pinned_pool_growths``, the
times PyTorch's pinned-memory pool grew (``num_host_alloc`` of its host allocator's
statistics, read at the snapshot).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .errors import DeviceUnavailableError
from .utils.profiling import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
# -Xptxas=-v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C signatures of the entry points, in the order of their arguments.
_SIGNATURES = {
    # (in, out, n_blocks, variant, split, stream)
    "dlt_bc1_transform": (_P, _P, _I, _I, _I, _P),
    "dlt_bc1_untransform": (_P, _P, _I, _I, _I, _P),
    # (in, out, n_blocks, candidate code, n_candidates, stream)
    "dlt_bc1_regions": (_P, _P, _I, _I, _I, _P),
    # (rows, counts, n_rows, row_len, valid_len, offsets, weights, n_offsets,
    #  table, stream)
    "dlt_ltu_counts": (_P, _P, _I, _I, _I, _P, _P, _I, _P, _P),
    # (rows, counts, n_rows, row_len, valid_rows, max_valid, offsets, weights,
    #  n_offsets, table, stream)
    "dlt_ltu_counts_rows": (_P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _P),
    # (rows, counts, n_rows, row_len, valid_rows, pos0, lo, hi, offsets, weights,
    #  n_offsets, table, stream)
    "dlt_ltu_counts_windowed": (_P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P),
    # (in, out, n words per stream, k streams, stream)
    "dlt_deinterleave_words": (_P, _P, _I, _I, _P),
    # (in, out, n_blocks, variant, split_alpha, split_colour, stream)
    "dlt_bc3_transform": (_P, _P, _I, _I, _I, _I, _P),
    "dlt_bc3_untransform": (_P, _P, _I, _I, _I, _I, _P),
    # (in, alpha_out, colour_out, n_blocks, alpha code, n_alpha, colour code,
    #  n_colour, stream)
    "dlt_bc3_regions": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (in, out, n_blocks, variant, split, stream)
    "dlt_bc2_transform": (_P, _P, _I, _I, _I, _P),
    "dlt_bc2_untransform": (_P, _P, _I, _I, _I, _P),
    # (in, out, n_blocks, candidate code, n_candidates, stream)
    "dlt_bc2_regions": (_P, _P, _I, _I, _I, _P),
    # (in, out, n_blocks, split, stream)
    "dlt_bc4_transform": (_P, _P, _I, _I, _P),
    "dlt_bc4_untransform": (_P, _P, _I, _I, _P),
    "dlt_bc5_transform": (_P, _P, _I, _I, _P),
    "dlt_bc5_untransform": (_P, _P, _I, _I, _P),
    # (in, out, n_blocks, fmt, sort, planes, stream)
    "dlt_bc7_transform": (_P, _P, _I, _I, _I, _I, _P),
    # (in, out, n_blocks, sort, planes, stream)
    "dlt_bc7_untransform": (_P, _P, _I, _I, _I, _P),
    # (in, out, n_pixels, stride, ri, gi, bi, dec, split, stream)
    "dlt_rgb_transform": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dlt_rgb_untransform": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (in, out, block counts, best, n_rows, bucket, candidate code, n_candidates,
    #  stream)
    **{f"dlt_{fmt}_transform_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _P)
       for fmt in ("bc1", "bc2", "bc3", "bc4", "bc5")},
}

# Queries of a kernel's launch shape: they launch nothing and write int64 results
# into their last argument.
_QUERIES = {
    # (n_rows, positions, form, out[4])
    "dlt_ltu_counts_shape": (_I, _I, _I, _P),
    # (n_blocks, fmt, sort, planes, out[4])
    "dlt_bc7_transform_shape": (_I, _I, _I, _I, _P),
    # (n_blocks, sort, planes, out[4])
    "dlt_bc7_untransform_shape": (_I, _I, _I, _P),
}

#: Launches per kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {name: 0 for name in _SIGNATURES}

#: The program's counters since the last :func:`reset_counters`; read :func:`counters`.
COUNTS = dict.fromkeys(("batch.blocks_real", "batch.blocks_launched",
                        "batch.files_device_bytes", "batch.copy_bytes_parallel",
                        "batch.copy_bytes_serial", "batch.copy_threads", "zstd.buffers",
                        "zstd.bytes", "zstd.contexts", "zstd.worker_us",
                        "auto.payload_bytes"), 0)

_lib: Optional[ctypes.CDLL] = None
# held across the check, the build and the load of the library
_build_lock = threading.RLock()
# guards LAUNCHES and COUNTS
_launch_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc failed to build the kernel library."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error code."""


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names the CPU.

    Raises :class:`DeviceUnavailableError` for a CUDA device on a machine without
    one; there is no silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailableError(f"unsupported device {dev}")
    return dev


def sources() -> list:
    """The ``.cu`` files that the one ``nvcc`` call compiles."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libdlt_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise DeviceUnavailableError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> tuple:
    """Compile the kernel library if it is not built yet.

    Returns ``(path, compiler_output)``; the output is empty when the library was
    already there."""
    with _build_lock:
        path = library_path()
        if path.exists():
            return path, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(p) for p in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        return path, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _lib
    if _lib is None:
        with _build_lock:
            if _lib is None:
                path, _ = build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point ``name`` on ``device``'s current stream; count the
    launch."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(f"{name} failed with CUDA error {rc}")
    with _launch_lock:
        LAUNCHES[name] += 1


def query(name: str, device: torch.device, *args) -> list:
    """The four int64 results of launch-shape query ``name`` on ``device``."""
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(device):
        rc = getattr(library(), name)(*args, ctypes.addressof(out))
    if rc != 0:
        raise KernelLaunchError(f"{name} failed with CUDA error {rc}")
    return list(out)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``."""
    with _launch_lock:
        COUNTS[name] += n


def set_count(name: str, n: int) -> None:
    """Set counter ``name`` to ``n``: a width, the last value seen."""
    with _launch_lock:
        COUNTS[name] = n


def counters() -> dict:
    """A snapshot of the counters and of the pinned pool's growths, as plain ints."""
    with _launch_lock:
        out = dict(COUNTS)
    stats = torch.cuda.host_memory_stats()  # empty until CUDA is initialised
    out["pinned_pool_growths"] = int(stats.get("num_host_alloc", 0))
    return out


def reset_counters() -> None:
    with _launch_lock:
        for name in COUNTS:
            COUNTS[name] = 0


def require_cuda_tensor(t: torch.Tensor, what: str, dtype: torch.dtype,
                        align: int = 4) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of ``dtype`` whose data
    pointer is ``align``-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.numel() and t.data_ptr() % align:
        raise ValueError(f"{what}: data pointer is not {align}-byte aligned")


def dispatch(t: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False to take the plain version
    (CPU tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def upload(data, device: torch.device) -> torch.Tensor:
    """Host bytes -> uint8 tensor on ``device``, through a pinned buffer for CUDA."""
    src = np.frombuffer(data, np.uint8)
    if device.type != "cuda":
        return torch.from_numpy(src.copy())
    pinned = torch.empty(src.size, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = src
    out = pinned.to(device, non_blocking=True)
    # the copy reads ``pinned`` asynchronously: it must finish before ``pinned`` goes
    torch.cuda.current_stream(device).synchronize()
    return out


def download(t: torch.Tensor) -> bytes:
    """uint8 tensor -> host bytes, through a pinned buffer for CUDA."""
    if not t.is_cuda:
        return t.contiguous().numpy().tobytes()
    pinned = torch.empty(t.numel(), dtype=torch.uint8, pin_memory=True)
    pinned.copy_(t.reshape(-1), non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return pinned.numpy().tobytes()


def host_buffer(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An uninitialised host tensor in which to assemble a copy to ``device``:
    pinned when ``device`` is a CUDA device."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor from :func:`host_buffer` -> ``device``, asynchronously for CUDA
    (PyTorch's pinned-memory allocator keeps the buffer until the copy has run); the
    CPU takes the tensor itself."""
    return t.to(device, non_blocking=True) if device.type == "cuda" else t


class Download:
    """Device tensors copied to the host: the copies are queued on the current stream
    when the object is made, and :meth:`wait` returns them as numpy arrays, so that
    work queued after them runs while the host waits for these."""

    def __init__(self, tensors):
        tensors = [t.contiguous() for t in tensors]
        self._event = None
        if tensors and tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensors

    def wait(self) -> list:
        with span("dlt.backend.wait"):
            if self._event is not None:
                self._event.synchronize()
        return [h.numpy() for h in self._host]
