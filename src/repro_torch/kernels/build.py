"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

The sources are compiled for Hopper (``sm_90a``) on first use: one ``nvcc -c``
per source, all started together, then one link into a shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/kernels/<hash of sources and flags>/`` under the checkout (listed in
``.gitignore``; ``REPRO_TORCH_BUILD_DIR`` moves it), so a changed source
rebuilds and an unchanged one loads.  Nothing here runs at import time: the
CPU tests import every module of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_REPO = Path(__file__).resolve().parents[3]
# ptxas statistics (-Xptxas -v) are always on: they change only the log, and
# one flag set gives one build directory for every process of a checkout
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

_vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "w2a8_gemv_launch": [_vp] * 4 + [_i] * 5 + [_vp, _i, _vp, _vp],
    "w2a8_gemv_acc_launch": [_vp] * 4 + [_i] * 5 + [_vp, _i, _vp, _vp],
    "w2a8_gemv_info": [ctypes.POINTER(_ll)],
    "paged_plan_query": [_i] * 7 + [ctypes.POINTER(_ll)],
    "paged_attention_decode_launch": [_vp] * 9 + [_ll] + [_i] * 6 + [_f] * 2 + [_i] * 2 + [_vp],
    "paged_prefill_chunk_launch": [_vp] * 10 + [_ll] + [_i] * 7 + [_f] * 2 + [_i] * 2 + [_vp],
    "bitlinear_quant_launch": [_vp] * 4 + [_i] * 4 + [_vp],
    "bitlinear_weight_launch": [_vp] * 4 + [_i] * 4 + [_vp],
    "bitlinear_gemm_launch": [_vp] * 5 + [_i] * 4 + [_vp],
    "bitlinear_launch": [_vp] * 9 + [_i] * 6 + [_vp],
    "bitlinear_gemm_info": [ctypes.POINTER(_ll)],
    "relation_kd_plan_query": [_i] * 3 + [ctypes.POINTER(_ll)],
    "relation_kd_launch": [_vp] * 4 + [_ll, _vp, _ll] + [_i] * 3 + [_f] + [_vp],
    "ssd_scan_launch": [_vp] * 8 + [_i] * 6 + [_vp],
    "ssd_scan_workspace": [_i] * 6,
}
_RESTYPES = {"ssd_scan_workspace": ctypes.c_longlong}


class LaunchCounter:
    """Number of kernel launches a wrapper made; reset before a run to show
    that the run went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float          # 0.0 when the library was already built
    log: str                # compiler output, with ptxas statistics


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return str(path)


def _build_dir(flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    root = Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _REPO / "build" / "kernels"))
    return root / h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile (if needed) and load the kernel library; returns where it is,
    how long the build took (0 when it was built already) and the
    compiler's output (kept beside the library)."""
    global _lib, _info
    if _lib is not None:
        return _info
    flags = NVCC_FLAGS
    out_dir = _build_dir(flags)
    so = out_dir / "librepro_torch_kernels.so"
    log_file = out_dir / "nvcc.log"
    log, seconds = "", 0.0
    if so.exists() and log_file.exists():
        log = log_file.read_text()
    if not so.exists():
        t0 = time.perf_counter()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tmp = Path(tempfile.mkdtemp(dir=out_dir))
        srcs = sorted(CSRC.glob("*.cu"))
        procs = [(src, subprocess.Popen(
            [nvcc, *flags, "-I", str(CSRC), "-c", str(src),
             "-o", str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in srcs]
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            log += f"== {src.name}\n{text}"
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, *flags, "-shared", "-o", str(tmp / so.name),
             *[str(tmp / (s.stem + ".o")) for s in srcs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += link.stdout
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        log_file.write_text(log)
        os.replace(tmp / so.name, so)
        shutil.rmtree(tmp, ignore_errors=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.repro_torch_error_string.argtypes = [ctypes.c_int]
    lib.repro_torch_error_string.restype = ctypes.c_char_p
    _lib, _info = lib, BuildInfo(so, seconds, log)
    return _info


def library() -> ctypes.CDLL:
    build()
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs
    and ``synchronize`` would not report it)."""
    if err != 0:
        msg = _lib.repro_torch_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """The current stream's handle on ``device``, read the way PyTorch's own
    generated kernels read it: no ``torch.cuda.Stream`` object is built on
    the way (the wrappers run once per layer and projection, host-bound)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported by the kernel "
                        f"(takes {sorted(str(d) for d in DTYPE_CODES)})")
    return DTYPE_CODES[t.dtype]


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous, or raise."""
    dev = tensors[0].get_device()
    for i, t in enumerate(tensors):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: operand {i} is on {t.device}; every "
                             "operand must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")
