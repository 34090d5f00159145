"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on
first use, with ``nvcc`` for ``sm_90a``, into its own shared library
under the git-ignored ``build/`` directory beside ``csrc/`` (override
with ``REPRO_TORCH_BUILD_DIR``), then loaded with ``ctypes``.  A library
is named by the hash of its source, the shared headers and the flags, so
an edited source or header rebuilds and an unchanged one loads at once.
``build_all`` starts one ``nvcc`` per source, all together, and waits
for them.

Every launcher returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but ``cudaSuccess``.  ``LAUNCHES`` counts
the kernel launches of each wrapper (the wrappers add one where they
launch, nowhere else); ``flash_attention_q_offset`` counts the subset of
``flash_attention``'s launches with ``q_offset > 0`` (prefill chunks).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

SOURCES = ("decode_attention", "decode_attention_int4", "flash_attention",
           "int4_matmul")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Q_OFFSET = "flash_attention_q_offset"
LAUNCHES: Dict[str, int] = {name: 0 for name in (*SOURCES, Q_OFFSET)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}
_LOCK = threading.Lock()


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               CSRC.parent / "build"))


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels compile on the "
                       "machine with the card (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    """The library of ``name``, named by the hash of its source, every
    shared header (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns {name: seconds} for what was compiled and
    writes each compiler log (``-Xptxas -v``: registers, shared memory,
    spills) to ``build/<name>.log``.  Raises if any compile fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    jobs = {}
    for name in (SOURCES if names is None else names):
        final = lib_path(name)
        if final.exists():
            continue
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, final, time.perf_counter())
    secs, failed = {}, []
    for name, (proc, tmp, final, t0) in jobs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, final)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def launcher(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``fn`` of kernel library ``name`` (built on first
    use), with ``argtypes`` declared and an int (cudaError_t) result."""
    f = _FNS.get((name, fn))
    if f is not None:
        return f
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            err = lib.kernel_error_string
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        f = getattr(lib, fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
        _FNS[(name, fn)] = f
    return f


def check(name: str, err: int):
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = _LIBS[name].kernel_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor):
    """The wrappers' guard: every tensor on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors")
