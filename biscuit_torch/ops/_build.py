"""Build the port's CUDA kernels at first use and count their launches.

Each ``csrc/<source>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` into ``_build/lib<source>-<hash>.so`` (the hash covers
the source and every header in ``csrc/``, so an edited source never loads
a stale library), then loaded with ``ctypes``. No PyTorch header is
compiled, which keeps a build to seconds. ``build_all`` starts one
``nvcc`` for each source at once and waits for all of them.

``KERNELS`` names the kernels as the launch counts know them; a source
may hold more than one (``SOURCE``), and ``REPLACES`` gives the TPU
kernel each one ports, or says that it ports none. Every wrapper that
launches a kernel adds one to its count here (a ``launch.<kernel>``
counter of ``tracing``), and nowhere else, so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .. import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCE = {"fused_preprocess": "fused_preprocess",
          "fused_middle_flow": "fused_middle_flow",
          "mcd_head": "mcd_head",
          "unit_bwd_plane": "fused_unit_bwd",
          "unit_bwd_strips": "fused_unit_bwd",
          "fused_block": "fused_block",
          "depthwise3x3": "depthwise3x3",
          "bn_train_fwd": "bn_train",
          "bn_train_bwd": "bn_train"}
KERNELS = tuple(SOURCE)
SOURCES = tuple(dict.fromkeys(SOURCE.values()))
REPLACES = {
    "fused_preprocess": "biscuit_tpu/ops/fused_preprocess.py:73",
    "fused_middle_flow": "biscuit_tpu/ops/fused_sepconv.py:99",
    "mcd_head": "biscuit_tpu/ops/mcd_head.py:40",
    "unit_bwd_plane": "biscuit_tpu/ops/fused_unit_bwd.py:186",
    "unit_bwd_strips": "biscuit_tpu/ops/fused_unit_bwd.py:364",
    "fused_block": "biscuit_tpu/ops/fused_block.py:115",
    "depthwise3x3": "biscuit_tpu/ops/depthwise_pallas.py:38",
    "bn_train_fwd": "none: train-mode BatchNorm, left to XLA by the JAX "
                    "package",
    "bn_train_bwd": "none: train-mode BatchNorm, left to XLA by the JAX "
                    "package",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_fns: dict = {}


def count_launch(name: str) -> None:
    if name not in SOURCE:
        raise KeyError(name)
    tracing.count("launch." + name)


def launch_counts() -> dict:
    """Each kernel's launches (the ``launch.<kernel>`` counters of
    ``tracing``), every kernel named, zeros included."""
    counted = tracing.counts()
    return {name: counted.get("launch." + name, 0) for name in KERNELS}


def reset_launch_counts() -> None:
    """Zero the launch counters (no other counter of ``tracing``)."""
    tracing.reset_counts("launch.")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(BUILD_DIR / f"{name}.log", "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except BaseException:
        log.close()
        raise
    return proc, log, tmp, out


def _finish(name: str, job) -> None:
    proc, log, tmp, out = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}); see "
                           f"{BUILD_DIR / (name + '.log')}:\n"
                           + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Build every kernel source's library that is not built yet, in
    parallel."""
    jobs = {}
    try:
        for name in names:
            jobs[name] = _start(name)
    finally:
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise RuntimeError("\n".join(str(e) for e in errors))


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the last build of the
    source ``name``."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library of the source ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def bound(name: str, symbol: str, argtypes,
          restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of the source ``name`` (a launcher
    returning a cudaError_t unless ``restype`` says otherwise), its
    prototype set once and kept."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _fns[symbol] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on t's card, read as the raw handle
    (``torch.cuda.current_stream`` would build a Stream object on every
    launch)."""
    import torch

    index = t.device.index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
