"""Build and load the port's CUDA kernels (sources under `ops/csrc/`).

Each `.cu` file has a plain C interface and is compiled by `nvcc` on its
own into a shared library that `ctypes` loads. No source includes
PyTorch's headers, so a build takes seconds rather than the minutes a
`torch.utils.cpp_extension.load` build of the same kernels takes.

  * Target `sm_90a` (Hopper), `-O3`.
  * Output: `rcmvsnet_tpu_torch/.ext_build/lib<name>_<hash>.so`, keyed by a
    hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so
    an edited source rebuilds and an unchanged one is reused. `.gitignore`
    lists the directory.
  * `build_all()` starts one `nvcc` per source, all at once, and waits,
    holding an exclusive lock on `.ext_build/.lock` (`fcntl.flock`), so
    the processes of a data-parallel run that reach their first launch
    together build each library once and load it whole.
  * A failed build raises with the compiler's output; nothing catches it.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` as an int, which the wrappers turn into an exception.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".ext_build"
SOURCES = ("warp_variance", "conv3d", "conv2d", "warp_volume", "conv3d_dw",
           "warp_view", "depth_tail")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMS = 132                     # streaming multiprocessors of an H100; the
                              # wrappers size their grids by it

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): the port's kernels cannot build")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str, csrc: Path = CSRC) -> Path:
    src = (csrc / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _start(name: str, csrc: Path = CSRC):
    """Start nvcc for one source; returns (Popen, tmp path, target) or
    None when the library is already built."""
    target = _target(name, csrc)
    if target.exists():
        return None
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


@contextlib.contextmanager
def _dir_lock():
    """This thread's and, through flock, this process's hold on the build
    directory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names=SOURCES, csrc: Path = CSRC) -> dict[str, str]:
    """Compile every named source of `csrc` in parallel. Returns {name:
    nvcc output} (the `-Xptxas -v` register and shared-memory report);
    raises on the first failed build."""
    with _dir_lock():
        jobs = {n: _start(n, csrc) for n in names}
        logs = {}
        failed = []
        for name, job in jobs.items():
            if job is None:
                logs[name] = "(cached)"
                continue
            proc, tmp, target = job
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `ops/csrc/<name>.cu`, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib


def load_from(csrc: Path, names) -> dict[str, ctypes.CDLL]:
    """Build the named sources of another directory with the same flags
    (targets keyed by content, beside the package's own) and load them;
    the libraries `load` serves are left as they are."""
    build_all(names, csrc)
    return {n: ctypes.CDLL(str(_target(n, csrc))) for n in names}


def check(err: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """A kernel takes float32, contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {[x.device for x in tensors]}")
        if t.dtype.is_floating_point and t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
