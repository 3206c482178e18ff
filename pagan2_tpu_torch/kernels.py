"""Build and load the hand-written CUDA kernels under csrc/.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc
for Hopper (sm_90a) into its own shared library under the checkout's
ignored `build/kernels/` directory, at first use and again whenever the
source, or a header of csrc/ that it includes, is newer than the
library. The library is loaded with ctypes;
pointers and the stream travel as c_void_p. Nothing here runs when a
module is imported, so the CPU tests (no nvcc, no card) import freely.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source extra flags. The probability fills are held bit-equal to
# plain versions that round after every operation, so nvcc must not
# contract a multiply and an add into one FMA there.
EXTRA_FLAGS = {"fullprob_fwd": ["-fmad=false"],
               "fullprob_bwd": ["-fmad=false"]}

# dynamic shared memory a block may take on an H100 (with the opt-in);
# the launch plans of kernels B and E count against it
SHARED_BYTES = 227 * 1024

_libs: dict = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per kernel
BUILD_LOG: dict = {}
# seconds each source's nvcc took (the sources build side by side)
BUILD_SECONDS: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _paths(name: str):
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, "lib%s.so" % name))


def _inputs(path: str) -> list:
    """`path` and the csrc/ headers it includes ("..."), in turn."""
    with open(path) as f:
        names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)
    out = [path]
    for n in names:
        out += _inputs(os.path.join(CSRC, n))
    return out


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return (not os.path.exists(so) or os.path.getmtime(so)
            < max(os.path.getmtime(p) for p in _inputs(src)))


def _start(name: str):
    src, so = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = [nvcc_path()] + NVCC_FLAGS + EXTRA_FLAGS.get(name, []) + \
        ["-o", tmp, src]
    # nvcc's report goes to a file, so that no process waits on a full
    # pipe while another one is awaited
    log = open(tmp + ".log", "w+")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    return proc, log, tmp, so


def _finish(name: str, proc, log, tmp: str, so: str):
    proc.wait()
    log.seek(0)
    out = log.read()
    log.close()
    os.remove(log.name)
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for csrc/%s.cu:\n%s" % (name, out))
    os.replace(tmp, so)


def build(*names: str) -> None:
    """Compile the named kernels that are missing or stale, one nvcc
    process per source, all started together; BUILD_SECONDS gets each
    one's time."""
    todo = [n for n in names if _stale(n)]
    t0 = time.time()
    started = [(n,) + _start(n) for n in todo]
    running = {n: proc for n, proc, *_rest in started}
    while running:
        for n, proc in list(running.items()):
            if proc.poll() is not None:
                BUILD_SECONDS[n] = time.time() - t0
                del running[n]
        time.sleep(0.05)
    errors = []
    for n, proc, log, tmp, so in started:
        try:
            _finish(n, proc, log, tmp, so)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built if needed and loaded once."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(_paths(name)[1])
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (what, err))
