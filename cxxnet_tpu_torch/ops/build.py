"""The kernel seam: builds ``csrc/*.cu`` with nvcc and loads them with ctypes.

The port's counterpart of ``cxxnet_tpu/ops/pallas_env.py``: where the JAX
package decides between a compiled and an interpreted Pallas kernel, the
port decides nothing here — a kernel wrapper hands a CUDA tensor to the
library this module builds, and a CPU tensor to the kernel's plain
PyTorch version, by the tensor's device alone.

Each source is compiled on its own into ``build/<name>-<hash>.so`` (the
hash is of the source bytes, so an edited kernel is rebuilt and a
cached one is reused), with a plain C interface, for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

All sources are compiled at once, one nvcc process each, at the first
kernel call of the process (or by an explicit :func:`build_all`).
Nothing is downloaded; a failed build raises with nvcc's output.
Every C entry returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable] = {}
# {source name: nvcc's output (ptxas register/shared-memory report)} and
# the wall seconds of the last build_all, for chip_smoke.py to print
build_log: Dict[str, str] = {}
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    """The CUDA toolkit's nvcc: on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels are built from cxxnet_tpu_torch/csrc at first use")


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _target(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, digest))


def build_all() -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, all nvcc processes
    started together; returns {name: library path}. Raises on the first
    failed compile, with its output."""
    global build_seconds
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {os.path.splitext(os.path.basename(s))[0]: (s, _target(s))
               for s in sources()}
    procs = []
    for name, (src, out) in targets.items():
        if os.path.exists(out):
            continue
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp, src]
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, cmd, proc in procs:
        log = proc.communicate()[0].decode("utf-8", "replace")
        build_log[name] = log
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n$ %s\n%s"
                          % (name, proc.returncode, " ".join(cmd), log))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return {name: out for name, (_, out) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source on the first call of the process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise RuntimeError("no kernel source csrc/%s.cu" % name)
            lib = _libs[name] = ctypes.CDLL(paths[name])
        return lib


def function(name: str, entry: str, argtypes: Sequence) -> Callable:
    """The C entry ``entry`` of the library built from ``csrc/<name>.cu``,
    typed once per process: ``argtypes`` (``c_void_p`` for pointers and
    the stream, ``c_int`` for ints), returning the ``int`` CUDA error
    code :func:`check` reads."""
    key = (name, entry)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(name), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[key] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise when a C entry of the library ``name`` returned a CUDA
    error code."""
    if err != 0:
        msg = library(name).cxx_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError("%s: CUDA error %d at launch: %s"
                           % (what, err, msg(err).decode("utf-8",
                                                         "replace")))
