"""Builds the port's native sources and loads them with ctypes.

CUDA library ``<name>`` is ``csrc/<name>.cu`` with its parts
``csrc/<name>.<part>.cu`` (a large set of kernel instantiations spread
over several translation units): each source compiles with nvcc for
``sm_90a`` to an object, one nvcc process per source, all started
together, and the objects link into
``build/torch_kernels/<name>-<hash>.so`` at the repository root.  Host
library ``<name>`` is ``csrc/<name>.cpp``, one g++ compile into
``build/torch_kernels/<name>-<hash>.so`` (:func:`host_library`).  Each
``<hash>`` covers that library's own sources (and, for CUDA, the shared
``*.cuh`` headers) and its flags, so an edited source rebuilds its own
library and no other.  The shared libraries have a plain C interface:
the wrappers pass pointers and the stream as ``ctypes.c_void_p``.

Importing this module needs no compiler; building happens when a CUDA
tensor first reaches a kernel wrapper (or :func:`build_all` is called),
and a missing nvcc raises then.  :func:`check_inputs` and :func:`launch`
are the wrappers' side of the binding: what may cross into a kernel, and
a launch on the current stream whose error code raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from ._device import KernelError, KernelInputError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append(os.path.join("/usr/local/cuda", "bin", "nvcc"))
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest(flags: Sequence[str], paths: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    """The build of CUDA library ``name``: its sources and the headers."""
    paths = _sources()[name] + sorted(CSRC.glob("*.cuh"))
    return BUILD_DIR / f"{name}-{_digest(NVCC_FLAGS, paths)}.so"


def _sources() -> Dict[str, List[Path]]:
    """Library name -> its sources (``<name>.cu`` and its parts)."""
    libs: Dict[str, List[Path]] = {}
    for path in sorted(CSRC.glob("*.cu")):
        libs.setdefault(path.name.split(".")[0], []).append(path)
    return libs


def _run(cmds) -> List[str]:
    """Run the commands together; the logs of those that failed."""
    procs = [(what, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
             for what, cmd in cmds]
    failed = []
    for what, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{what} (nvcc exit {proc.returncode}):\n{log}")
    return failed


def build_all() -> List[Path]:
    """Build every library that has no current build: one nvcc process
    per source, all started together, then one link per library; returns
    the libraries.  Raises with the compiler's output when a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # temporary names end in the suffix nvcc reads a file's kind from
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    todo = {name: srcs for name, srcs in _sources().items()
            if not _target(name).exists()}
    objs = {name: [_target(name).with_suffix(f".{src.stem}.{tag}.o")
                   for src in srcs] for name, srcs in todo.items()}
    failed = _run((src.name, [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                              str(src)])
                  for name, srcs in todo.items()
                  for src, obj in zip(srcs, objs[name]))
    if not failed:
        failed = _run((f"link {name}", [
            nvcc, NVCC_FLAGS[0], "-shared", "-o",
            str(_target(name).with_suffix(f".{tag}.so")),
            *map(str, objs[name])]) for name in todo)
    for name in todo:
        for obj in objs[name]:
            obj.unlink(missing_ok=True)
        tmp = _target(name).with_suffix(f".{tag}.so")
        if not failed:
            os.replace(tmp, _target(name))
        tmp.unlink(missing_ok=True)
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return [_target(name) for name in _sources()]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _target(name)
            if not so.exists():
                build_all()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise KernelError(f"cannot load {so}: {e}") from e
            _libs[name] = lib
        return lib


def host_library(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of ``csrc/<name>.cpp``, compiled with g++ on
    first use; None when g++ is missing or fails.  The result, a failure
    included, is kept for the process.  A racing build in another process
    is harmless: each compiles to a temporary name and renames it into
    place."""
    with _lock:
        if name not in _libs:
            _libs[name] = _build_host(name)
        return _libs[name]


def _build_host(name: str) -> Optional[ctypes.CDLL]:
    src = CSRC / f"{name}.cpp"
    so = BUILD_DIR / f"{name}-{_digest(GXX_FLAGS, [src])}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                                 capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def check_inputs(tensors: Sequence[torch.Tensor], kernel: str) -> None:
    """Raise unless every tensor is float32, contiguous and on the first
    one's device: the pointers a kernel takes carry no shape or type."""
    for t in tensors:
        if t.device != tensors[0].device:
            raise KernelInputError(f"the {kernel} kernel's inputs must share one "
                             f"device")
        if t.dtype != torch.float32:
            raise KernelInputError(f"the CUDA {kernel} kernel takes float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise KernelInputError(f"the CUDA {kernel} kernel needs contiguous "
                             f"inputs")


def launch(fn, device: torch.device, *args, what: str) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream; a non-zero return (-1: arguments the kernel does not take,
    else a ``cudaError_t``) raises."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise KernelError(f"{what}: " + ("unsupported arguments" if rc < 0
                                          else f"CUDA error {rc}"))
