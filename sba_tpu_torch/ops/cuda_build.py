"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``sba_tpu_torch/_build/`` (ignored by git) under
a name keyed by a hash of the sources, so an edited source is rebuilt
and concurrent processes never load a half-written file.
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
# cancels. K1-K5 are bound by memory, not by these instructions; K6 is
# bound by its operations and pays for the unfused products.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

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


def _sources(csrc: Path = CSRC_DIR):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path = CSRC_DIR) -> Path:
    h = hashlib.sha256()
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libsba_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC_DIR) -> tuple[Path, str]:
    """Compile the kernel sources in `csrc` (the package's own by
    default) unless this source state is already built. Returns (library
    path, compiler log; empty when nothing was built)."""
    out = library_path(csrc)
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = nvcc_path()
    srcs = sorted(csrc.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = []
    failed = []
    for cmd, proc in zip(cmds, procs):
        text, _ = proc.communicate(timeout=600)
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *[str(o) for o in objs]]
    res = subprocess.run(link, capture_output=True, text=True, timeout=600)
    for o in objs:
        o.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(link)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out, "".join(log) + res.stdout + res.stderr


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    # model, loss, loss_scale, schur_bf16, TP, K, Pp, Npad, C, Dk,
    # lam, par, free_sta, pts, free_pts, obs_sta, obs_img, obs_cam,
    # tiles, n_groups, n_img_groups, n_members, n_units, n_pairs, n_items,
    # scratch, S, img_red, ey, pt_pay, jw, stream
    "sba_fused_schur": [_I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P],
    # model, loss, loss_scale, bj, jcorr_bf16, TP, K, Pp, Npad, C,
    # lam, par, free_sta, pts, free_pts, obs_sta, obs_img, obs_cam,
    # img_red, pt_pay, jw, jcorr (null unless jcorr_bf16), stream
    "sba_fused_reduce": [_I, _I, _F, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P],
    # model, jcorr_bf16, TP, K, Pp, Npad, C,
    # du_pose_t, du_cam_t, jcorr, obs_sta, obs_img, obs_cam, out, stream
    "sba_schur_matvec": [_I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P],
    # model, TP, K, Pp, Npad, C,
    # lam, du_pose_t, du_cam_t, pt_pay, jw, obs_sta, obs_img, obs_cam,
    # dp, acc, stream
    "sba_backsub": [_I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # model, loss, loss_scale, n_buckets, Npad, par,
    # dims (host int[3n]: TP, K, Pp), ptrs (host void*[3n]: pts, obs_sta,
    # obs_img), work, work_words, out, stream
    "sba_fused_cost_buckets": [_I, _I, _F, _I, _I, _P,
                               ctypes.POINTER(_I), ctypes.POINTER(_P),
                               _P, _I, _P, _P],
    "sba_fused_cost_work_words": [],
    # nparams, Npad, par
    "sba_fused_cost_stages": [_I, _I, _P],
    # H, W, S, r, step, sigma_spatial, inv2sc2, fin_min,
    # ref, v, inb, cost, stream
    "sba_ncc_cost": [_I, _I, _I, _I, _I, _D, _F, _F,
                     _P, _P, _P, _P, _P],
    # word_bytes, n, per, hw, table, idx, out, stream
    "sba_map_gather": [_I, _L, _L, _L, _P, _P, _P, _P],
    # n, per, hw, sum, table, idx, out, stream
    "sba_map_gather_pair": [_L, _L, _L, _I, _P, _P, _P, _P],
}


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points."""
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.sba_error_string.argtypes = [_I]
    cdll.sba_error_string.restype = ctypes.c_char_p
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = load(build()[0])
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib().sba_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
