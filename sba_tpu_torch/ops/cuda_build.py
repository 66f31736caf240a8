"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ONE ``nvcc`` call for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``sba_tpu_torch/_build/`` (ignored by
git) under a name keyed by a hash of the sources, so an edited source
is rebuilt and concurrent processes never load a half-written file.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -fmad=false: products are rounded before they are added, as in the
# plain twins (separate PyTorch ops), so that kernel and twin agree to
# the f32 tolerances of the reference tests even where a 3x3 inverse
# cancels; the kernels are bound by memory, not by these instructions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIB = None


def nvcc_path() -> str:
    """nvcc from PyTorch's CUDA_HOME, else /usr/local/cuda (PATH is not
    consulted)."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(f"nvcc not found (looked at {candidates})")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsba_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless this source state is already built.
    Returns (library path, compiler log; empty when nothing was built)."""
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # model, loss, loss_scale, schur_bf16, TP, K, Pp, Npad, C, Dk,
    # lam, par, free_sta, pts, free_pts, obs_sta, obs_img, obs_cam,
    # S, img_red, ey, pt_pay, jw, stream
    "sba_fused_schur": [_I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P],
    # model, TP, K, Pp, Npad, C,
    # lam, du_pose_t, du_cam_t, pt_pay, jw, obs_sta, obs_img, obs_cam,
    # dp, acc, stream
    "sba_backsub": [_I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # model, loss, loss_scale, TP, K, Pp, Npad,
    # par, pts, obs_sta, obs_img, acc, stream
    "sba_fused_cost": [_I, _I, _F, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.sba_error_string.argtypes = [_I]
        cdll.sba_error_string.restype = ctypes.c_char_p
        _LIB = cdll
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib().sba_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
