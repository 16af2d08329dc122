"""Builds the hand-written CUDA kernels into one shared library.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together), linked into ``libkernels.so`` with a
plain C interface and loaded with ``ctypes``. The build happens at first
use, from the sources in this package and nothing else, into ``build/`` at
the root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides), in a
directory named after a hash of the flags, the sources and the headers
they include (``csrc/*.cuh``), so an unchanged tree reuses its library and
an edit to a header builds anew. Nothing here runs when the package is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# a launch that returns MAP_ERROR + n did not run: cuTensorMapEncodeTiled
# refused one of its TMA tensor maps with CUresult n
MAP_ERROR = 10000

_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built at first use and need it")


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def _source_hash(srcs) -> str:
    """Of the flags, ``srcs`` and every header beside them."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for s in list(srcs) + headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, srcs, out_dir: Path) -> str:
    """One ``nvcc -c`` per source in parallel, then one link. Returns the
    compiler's output (``-Xptxas -v`` reports registers and spills)."""
    procs = []
    for s in srcs:
        obj = out_dir / (s.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs = [], []
    for s, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
        objs.append(str(obj))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(out_dir / "libkernels.so"), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return "\n".join(log) + link.stdout


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if this tree's build is missing."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    final = build_root() / "repro_torch_kernels" / _source_hash(srcs)
    so = final / "libkernels.so"
    t0 = time.perf_counter()
    built = False
    if not so.is_file():
        nvcc = find_nvcc()
        final.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp_", dir=final.parent))
        try:
            log = _compile(nvcc, srcs, tmp)
            (tmp / "build.log").write_text(log)
            try:
                os.replace(tmp, final)  # atomic: a concurrent build may win
            except OSError:
                if not so.is_file():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        built = True
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    log_file = final / "build.log"
    _info.update(
        library=str(so), built=built,
        seconds=time.perf_counter() - t0,
        sources=[str(s.relative_to(CSRC.parents[3])) for s in srcs],
        log=log_file.read_text() if log_file.is_file() else "",
    )
    _lib = lib
    return lib


class on_device:
    """Make ``device`` the current CUDA device around a launch; does nothing
    (and costs nothing) when it already is."""

    def __init__(self, device):
        import torch

        self._ctx = None
        if device.index is not None and \
                device.index != torch.cuda.current_device():
            self._ctx = torch.cuda.device(device)

    def __enter__(self):
        if self._ctx is not None:
            self._ctx.__enter__()

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)


def build_info() -> Dict[str, object]:
    """Where the library is, whether this process built it, how long that
    took and what the compiler printed. Empty before the first load."""
    return dict(_info)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.staged_scatter_launch.restype = i32
    lib.staged_scatter_launch.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i64, i32, i64, i64, vp]
    lib.flash_decode_paged_launch.restype = i32
    lib.flash_decode_paged_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, vp]
    lib.flash_decode_paged_prepare.restype = i32
    lib.flash_decode_paged_prepare.argtypes = []
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [i32] * 6 + [i64] * 12 + [i32, i32, ctypes.c_float, i32, vp])
    lib.flash_decode_launch.restype = i32
    lib.flash_decode_launch.argtypes = (
        [vp] * 5 + [i32] * 7 + [ctypes.c_float, i32, vp])
    lib.cms_update_launch.restype = i32
    lib.cms_update_launch.argtypes = [vp, vp, i32, vp, i64, i32, i32, vp]
    lib.cms_query_launch.restype = i32
    lib.cms_query_launch.argtypes = [vp, vp, i32, vp, i64, i32, i32, vp]
    lib.lru_scan_launch.restype = i32
    lib.lru_scan_launch.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp]
    lib.lru_step_probe_launch.restype = i32
    lib.lru_step_probe_launch.argtypes = [i64, i32, i32, vp, vp]
    lib.cms_update_query_launch.restype = i32
    lib.cms_update_query_launch.argtypes = [
        vp, vp, vp, vp, i32, vp, vp, i64, i32, i32, i64, i32, i32, vp]
