"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` into an object, and the objects are linked into
``build/torch_kernels/libhunter_kernels.so`` beside the package, at first
use.  The library has a plain C interface, bound with ``ctypes``: every
pointer and the stream travel as ``c_void_p``, every C function returns the
``cudaError_t`` of its launch and the wrappers raise on a non-zero code.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libhunter_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "hk_gj_inverse": [_P, _P, _I, _I, _I, _P],
    # 12 inputs, 11 outputs, n_knots, proj_reg, hess_reg, pivot, stream
    "hk_project_knot": [_P] * 23 + [_I, _F, _F, _I, _P],
    # 12 inputs, 4 outputs, batch, n_knots, reg, stream
    "hk_riccati_solve": [_P] * 16 + [_I, _I, _F, _P],
    # 12 inputs, 4 outputs, 4 scratch buffers, batch, n_knots, reg, stream
    "hk_riccati_assoc": [_P] * 20 + [_I, _I, _F, _P],
    # 10 inputs (x0, lam0, nu0, margin may be NULL), 5 outputs, batch, n, me, mi, n_iters,
    # margin stride, eq_reg, frac, mu_min, margin value, stream
    "hk_solve_qp": [_P] * 15 + [_I] * 6 + [_F] * 4 + [_P],
    # consts, params, Q, R, 6 inputs, 13 outputs, batch, n_knots, dt, stream
    "hk_soa_linearize": [_P] * 23 + [_I, _I, _F, _P],
    # consts, params, Q, R, 6 inputs, partials, tickets, 2 outputs, batch, n_cand, n_knots,
    # dt, stream
    "hk_soa_merit": [_P] * 14 + [_I, _I, _I, _F, _P],
    # n_knots -> the merit's partial sums per (scenario, candidate)
    "hk_soa_merit_partials": [_I],
    # out buffer, capacity
    "hk_soa_topology": [_P, _I],
    # consts, lower, upper, 4 inputs, 2 outputs, decisions or NULL, batch, n_samples,
    # trans_it, rot_it, step, damp, stream
    "hk_leg_ik": [_P] * 10 + [_I] * 4 + [_F] * 2 + [_P],
    # consts, params, 5 inputs, 6 outputs, batch, stream
    "hk_wbc_qp": [_P] * 13 + [_I, _P],
    # consts, params, effort, 5 inputs, 4 outputs, decisions or NULL, batch, substeps, stream
    "hk_sim_step": [_P] * 13 + [_I, _I, _P],
    # consts, params, rbd, tau, p_scg_z_last, 3 outputs, batch, dt, stream
    "hk_momentum_observer": [_P] * 8 + [_I, _F, _P],
    # consts, params, 10 inputs, 2 outputs, batch, dt, stream
    "hk_kalman_update": [_P] * 14 + [_I, _F, _P],
    # q, v, base_acc, its row stride, 4 outputs, batch, stream
    "hk_synth_imu": [_P] * 3 + [_I] + [_P] * 4 + [_I, _P],
    # consts, rbd, x, batch, stream
    "hk_rbd_to_centroidal": [_P] * 3 + [_I, _P],
    # consts, x, u, x_out, batch, dt, stream
    "hk_dummy_step": [_P] * 4 + [_I, _F, _P],
    # consts, x, u, v, rbd or NULL, batch, stream
    "hk_state_input_to_v": [_P] * 5 + [_I, _P],
    # consts, 10 inputs, 6 swing-config scalars and arrays, 14 outputs, decisions or
    # NULL, the 10 inputs' batch strides, batch, target nodes, samples, horizon, stream
    "hk_swing_plan": [_P] * 32 + [_I] * 13 + [_F, _P],
    # 9 inputs, 6 outputs, decisions or NULL, 3 batch strides, batch, knots, samples,
    # horizon / intervals, stream
    "hk_knot_refs": [_P] * 16 + [_I] * 6 + [_F, _P],
    # 7 inputs, 3 outputs, 2 batch strides, batch, horizon, 2 horizon, stream
    "hk_contact_class": [_P] * 10 + [_I] * 3 + [_F] * 2 + [_P],
    # consts, params, Q, R, 10 inputs (K and kff may be NULL), 5 outputs, batch, n_alpha,
    # n_knots, integrator, max_substeps, dt, abs_tol, rel_tol, h_min, stream
    "hk_ddp_rollout": [_P] * 19 + [_I] * 5 + [_F] * 4 + [_P],
}

# a grid of one thread per scenario takes a batch up to the C int's range
MAX_SCENARIOS = 2 ** 31 - 1

_lib = None
build_log = ""
# the compiler's output of each measurement library, by the library's path,
# and the libraries loaded (one build per source and define in a process)
measurement_logs = {}
_measured = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")


def _stamp(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()


def build() -> float:
    """Compile (if the sources changed) and return the seconds it took."""
    global build_log
    t0 = time.perf_counter()
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    stamp = _stamp(sources)
    stamp_path = LIB_PATH + ".stamp"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read() == stamp:
                return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        so_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", so_tmp] + [o for _, o, _ in procs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, LIB_PATH)
        with open(stamp_path, "w") as f:
            f.write(stamp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


def _bind(lib, names):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        lib = _bind(ctypes.CDLL(LIB_PATH), SIGNATURES)
        lib.hk_error_string.argtypes = [ctypes.c_int]
        lib.hk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def measurement_library(source: str, define: str | None, names, extra=()):
    """``csrc/<source>`` (or the file at the path ``source``) alone,
    compiled with ``-D<define>`` (none when define is None) and the nvcc
    flags ``extra`` (e.g. ``-fmad=false``) into a library of its own in
    BUILD_DIR (a measurement build, beside the package's), loaded, with the
    entry points ``names`` of SIGNATURES bound; built once a process."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(CSRC, source)
    tag = hashlib.sha256((os.path.abspath(path) + " ".join(extra)).encode()).hexdigest()[:8]
    so = os.path.join(BUILD_DIR, f"{os.path.splitext(os.path.basename(source))[0]}_"
                                 f"{(define or 'plain').lower()}_{tag}.so")
    if so not in _measured:
        flags = ([f"-D{define}"] if define else []) + list(extra)
        done = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-I", CSRC, "-shared", "-o", so,
                               path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} with {flags}:\n{done.stdout}")
        measurement_logs[so] = done.stdout
        _measured[so] = ctypes.CDLL(so)
    return _bind(_measured[so], names)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library().hk_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def rows(t: torch.Tensor, name: str, width: int):
    """A tensor (..., width) as the (B, width) contiguous rows a kernel with
    one thread per scenario takes, and its leading shape; refuses an empty
    batch (the dtype and device are ``require``'s to check)."""
    if t.dim() == 0 or t.shape[-1] != width:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected (..., {width})")
    flat = t.reshape(-1, width).contiguous()
    if not 0 < flat.shape[0] <= MAX_SCENARIOS:
        raise ValueError(f"{name}: {flat.shape[0]} scenarios, the kernel takes 1..{MAX_SCENARIOS}")
    return flat, t.shape[:-1]


def _entries_contiguous(t: torch.Tensor) -> bool:
    """``t[0].is_contiguous()`` read from the strides, without the view:
    every dim after the first of size > 1 at the contiguous stride."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size == 0:
            return True
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def require(t: torch.Tensor, name: str, dtype, shape, device=None, strided_rows=False,
            batch_stride=False) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of this dtype/shape
    (with ``strided_rows``, rows of contiguous entries at any row stride;
    with ``batch_stride``, each entry of dim 0 contiguous at any stride of
    dim 0, 0 included: an input shared by the batch through ``expand``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernel input must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if strided_rows:
        if t.stride(-1) != 1 or t.stride(0) < t.shape[-1]:
            raise ValueError(f"{name}: kernel takes rows of contiguous entries")
    elif batch_stride:
        if t.dim() == 0 or t.shape[0] == 0 or not _entries_contiguous(t):
            raise ValueError(f"{name}: kernel takes contiguous entries at any batch stride")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
