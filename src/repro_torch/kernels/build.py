"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, into ``build/repro_torch_kernels/<source hash>/`` at the
root of the checkout (a directory ``.gitignore`` lists), and runs again
whenever a source changes.  Each source compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects.
A failed build raises with ``nvcc``'s own error output.

Nothing here runs when the module is imported: the CPU tests import every
module of the port, on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]
# Kernels A and B are bit-exact with XLA: -fmad=false forbids contracting
# a*b+c into one FMA, so every f32 rounding is XLA's.  Kernel C
# (ssd_scan.cu) answers to an f32 tolerance and is bound by FFMA
# throughput, which that flag would halve, so it compiles without it.
EXTRA_FLAGS = {"fused_pack.cu": ["-fmad=false"],
               "topk_quant.cu": ["-fmad=false"]}


def cflags(src: Path) -> List[str]:
    """The nvcc flags of one source."""
    return CFLAGS + EXTRA_FLAGS.get(src.name, [])


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
        h.update(" ".join(cflags(p)).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(they run only on a machine with the CUDA toolkit)")


def _run_all(cmds: List[List[str]], log: Path) -> None:
    """Run the commands in parallel; raise with the stderr of any that
    fail.  Every process is waited for."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    with open(log, "a") as f:
        for c, (out, err) in zip(cmds, outs):
            f.write("$ " + " ".join(c) + "\n" + out + err)
    failed = [(c, err) for c, p, (_, err) in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            " ".join(c) + "\n" + err for c, err in failed))


def build_library() -> Path:
    """Path of the built library, building it if this source hash has no
    build yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        log = tmp / "build.log"
        cus = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (p.stem + ".o") for p in cus]
        _run_all([[nvcc, *cflags(src), "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)] for src, obj in zip(cus, objs)], log)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
                   *map(str, objs)]], log)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        tmp.rename(out_dir)
    except OSError:          # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """What nvcc printed for the current build (registers, spills)."""
    log = BUILD_ROOT / source_hash() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature
    declared (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build_library()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_pack_launch.argtypes = [vp, i32, vp, i32, vp]
    lib.fused_pack_launch.restype = i32
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.topk_quant_launch.argtypes = [i32, i64p, i64p, i64p, i32, i32, i32,
                                      i32, i32, i32, i32, vp, vp, vp]
    lib.topk_quant_launch.restype = i32
    lib.topk_channel_launch.argtypes = [i32, i64p, i64p, i64p, i64p, i64p,
                                        i64p, i32, i32, i32, i32, i32, i32,
                                        i64p, vp, vp]
    lib.topk_channel_launch.restype = i32
    lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                    i32, vp, vp, vp, vp]
    lib.ssd_scan_launch.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
