"""Build the CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` exposes a plain C interface (no PyTorch headers), so one
``nvcc`` run per source takes seconds rather than the minutes a PyTorch
extension build takes. Libraries go to ``kernels/build/`` beside the
sources (git-ignored), named by a hash of the flags and of every file in
the source's ``csrc/`` directory, so an edited source or header is rebuilt
and a built one is reused. :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "build"

#: kernel package -> its CUDA source
SOURCES = {
    "flash_attention": _HERE / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_attention_bwd": _HERE / "flash_attention" / "csrc" / "flash_bwd.cu",
    "cwise_median": _HERE / "cwise_median" / "csrc" / "cwise_median.cu",
    "pairwise_sqdist": _HERE / "pairwise_sqdist" / "csrc" / "gram.cu",
    "mda_diameter": _HERE / "mda_diameter" / "csrc" / "mda_diameter.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    """The library of ``name``, named by a hash of the flags and of every
    file in its source's ``csrc/`` directory (the headers it includes)."""
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(src.parent.iterdir()):
        if f.is_file():
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every missing library of ``names`` (default: all) in
    parallel. Returns each built library's ptxas report (empty when the
    library was already there). Raises with nvcc's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def ptxas_usage(report: str) -> dict[str, tuple[int, int, int]]:
    """Per kernel of a :func:`build` report (``ptxas -v``): its mangled
    name -> (registers, bytes of spill stores, bytes of spill loads)."""
    usage, fn, spill = {}, None, (0, 0)
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            usage[fn] = (int(m.group(1)), *spill)
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name`` (built if missing)."""
    lib = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        fn = lib.repro_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} at launch "
                           f"({fn(rc).decode()})")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
