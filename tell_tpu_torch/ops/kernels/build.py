"""Build and load the hand-written CUDA kernels of tell_tpu_torch/csrc/.

nvcc compiles every csrc/*.cu for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library lands in tell_tpu_torch/build/ (listed in
.gitignore) under a name keyed on a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the existing file.
The build happens at the first kernel launch, never at import. A failed
build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, bias, part, out, B, H, MG, hd, S, dtype, stream
    "tt_decode_attention": [_P] * 6 + [_I] * 6 + [_P],
    # q, k8, k_scale, v8, v_scale, bias, part, out, B, H, MG, hd, S,
    # packed4, dtype, stream
    "tt_decode_attention_q8": [_P] * 8 + [_I] * 7 + [_P],
    # q, k, v, bias, scores, stats, part, out, B, H, MG, hd, S, dtype,
    # stream
    "tt_decode_attention_single": [_P] * 8 + [_I] * 6 + [_P],
    # q, k4, k_scale, v4, v_scale, bias, scores, stats, part, out, B, H, MG,
    # hd, S, dtype, stream
    "tt_decode_attention_q4split": [_P] * 10 + [_I] * 6 + [_P],
    # q, k, v, key_pad, out, B, S, H, hd, scale, dtype, stream
    "tt_encoder_attention": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # x, w_km, w_blk, out, B, T, C, H, K, TT, HB, NFP, weight_softmax,
    # dtype, stream
    "tt_dynamic_conv": [_P] * 4 + [_I] * 10 + [_P],
    # x, table, pv, pi, pm, ps, vals, ids, lse, N, V, D, k, zero_row,
    # dtype, stream
    "tt_topk_logits": [_P] * 9 + [_I] * 6 + [_P],
    # x, q, s, M, K, dtype, device, stream
    "tt_int8_quant_rows": [_P] * 3 + [_I] * 4 + [_P],
    # xq, wq, sx, sw, bias, out, M, N, K, out_dtype, route, split, chunk,
    # grid, device, stream
    "tt_int8_gemm": [_P] * 6 + [_I] * 9 + [_P],
    # x, xq, sx, wq, sw, bias, out, M, N, K, dtype, route, split, chunk,
    # grid, device, stream
    "tt_int8_linear": [_P] * 7 + [_I] * 9 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels of tell_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    """The build's output path for the current sources and flags."""
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtell_tpu_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise if any fails, else return their
    stderr (nvcc's -Xptxas=-v report) in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return "".join(errs)


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source in parallel, then one link. nvcc's -Xptxas=-v report
    (registers, shared memory, spills per kernel) is kept beside the
    library as <name>.log."""
    out = library_path()
    if out.exists():
        return out
    tag = f"{out.stem}.{os.getpid()}"
    objdir = BUILD_DIR / tag
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [objdir / f"{src.stem}.o" for src in srcs]
    report = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                   for src, obj in zip(srcs, objs)])
    tmp = BUILD_DIR / f"{tag}.tmp"
    _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    out.with_suffix(".log").write_text(report)
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return out


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tt_error_string.argtypes = [ctypes.c_int]
            lib.tt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = lib.tt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
