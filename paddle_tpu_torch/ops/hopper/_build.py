"""Build the Hopper kernels with nvcc and bind them with ctypes.

Counterpart of ``paddle_tpu/native/__init__.py`` (build on demand, plain C
interface, ctypes).  Every ``paddle_tpu_torch/csrc/*.cu`` is compiled for
``sm_90a`` into one object each, all nvcc processes started together, and
linked into ``build/paddle_tpu_torch/libpaddle_tpu_torch_kernels.so`` at
the repository root, the equivalent of

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/paddle_tpu_torch/libpaddle_tpu_torch_kernels.so \\
         paddle_tpu_torch/csrc/*.cu

The library is rebuilt when a source is newer than it.  The check and the
build run under an exclusive ``fcntl.flock`` on ``BUILD_DIR/build.lock``,
taken on a file of the caller's own opening, so it excludes other threads
as well as other processes: the serving fleet starts several worker
processes at once on a fresh checkout, each finds the library stale, and
without the lock they would run nvcc into the same object files.  The
first caller builds; the others wait on the lock, find the library fresh
and load it.  The link writes ``LIB_PATH + ".tmp"`` and ``os.replace``s it
into place, so a reader never maps a half-written library.  A missing
nvcc or a failed compile raises: there is no fallback to the plain
versions.  The
C functions take every pointer and the stream as ``void*``, allocate
nothing, launch on the given stream and return ``cudaGetLastError()``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading
from typing import Callable, List, Optional, Tuple

import torch

__all__ = ["build", "lib", "check", "launch_args", "launch_args_cached",
           "dtype_code", "f16_note", "kernel_op",
           "device_guard", "wants_grad", "SOURCES", "LIB_PATH"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_ROOT = os.path.dirname(_PKG)
SOURCES: List[str] = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
_DEPS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*")))
BUILD_DIR = os.path.join(_ROOT, "build", "paddle_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libpaddle_tpu_torch_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K4's and K4-int8's masks: mask|NULL, its heads, rows and columns,
# tgt_mask|NULL, its heads, rows and columns, seq_lens_encoder|NULL
_MASKS = [_P, _I, _I, _I, _P, _I, _I, _I, _P]
# C entry -> argtypes; each returns the cudaError_t of its launch as int
_SIGNATURES = {
    # x, residual|NULL, w, out, residual_out|NULL, n, h, eps, 16-byte
    # packs, packs a thread, threads a row, rows a block, dtype, stream
    "ptt_rms_norm": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I,
                     _P],
    # q, k, v|NULL, out_q, out_k|NULL, k ring|NULL, v ring|NULL (the ring
    # mode), cos, sin, position offset|NULL, its bytes (4 or 8), table
    # rows, ring rows, B, S, H, KVH, D, q_stride_b, q_stride_s,
    # k_stride_b, k_stride_s, v_stride_b, v_stride_s, sign of sin, 16-byte
    # chunks, interleaved pairs, dtype, stream
    "ptt_rope": [_P] * 10 + [_I] * 8 + [ctypes.c_longlong] * 6 + [
        _F, _I, _I, _I, _P],
    # a, b, out, n, dtype, stream
    "ptt_swiglu": [_P, _P, _P, ctypes.c_longlong, _I, _P],
    # a, b, g, da, db, n, dtype, stream
    "ptt_swiglu_bwd": [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _P],
    # q, key_cache, value_cache, out, seq_lens_decoder, seq_lens_this_time,
    # cu_seqlens_q, block_tables, pre_key|NULL, pre_value|NULL, T, B, P,
    # NB, H, KV, D, block_size, pre_len, max_q_len, scale, query tile, key
    # tile, stages, splits, chunk, float32 output, the masks (_MASKS),
    # q's dtype, the caches' dtype, stream
    "ptt_paged_attention": ([_P] * 10 + [_I] * 10 + [_F] + [_I] * 6
                            + _MASKS + [_I, _I, _P]),
    # q, k, v (this step's, full precision), key_cache, value_cache
    # (uint8), k/v dequant scales [B, KV] float32, out, seq_lens_decoder,
    # seq_lens_this_time, cu_seqlens_q, block_tables, pre_key|NULL,
    # pre_value|NULL, T, B, P, NB, H, KV, D, block_size, pre_len, max_q_len,
    # k and v token strides, scale, query tile, key tile, splits, chunk,
    # tensor cores, float32 output, the masks, dtype, stream
    "ptt_paged_attention_int8": [_P] * 14 + [_I] * 10 + [
        ctypes.c_longlong] * 2 + [_F] + [_I] * 6 + _MASKS + [_I, _P],
    # q, k, v, out, lse, q_off|NULL, B, Sq, Sk, H, KVH, D, q/k/v strides
    # over (batch, seq, head), causal, q_off_host, scale, block_q, block_k,
    # dtype, stream
    "ptt_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            *[ctypes.c_longlong] * 9, _I, _I, _F, _I, _I, _I,
                            _P],
    # q, k, v, o, dout, lse, delta, dq_acc|NULL, dk/dv partials|NULL (bf16
    # workspaces), dq, dk, dv, B, Sq, Sk, H, KVH, D, q/k/v strides over
    # (batch, seq, head), causal, scale, block_q, block_k, heads per block,
    # dtype, stream
    "ptt_flash_attention_bwd": [_P] * 13 + [
        _I, _I, _I, _I, _I, _I, *[ctypes.c_longlong] * 9, _I, _F, _I, _I,
        _I, _I, _P],
    # p|NULL, w, m, v, g, t, gmul|NULL, skip|NULL, n, lr, b1, b2, 1 - b1,
    # 1 - b2, eps, wd, p_dtype, g_dtype, stream
    "ptt_fused_adamw": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                        *[_F] * 7, _I, _I, _P],
    # q, kbuf, vbuf, out, pos, B, L, H, KVH, D, scale, splits, dtype,
    # stream
    "ptt_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                             _I, _P],
    # kbuf, vbuf, k_new, v_new, pos, B, L, S, row_bytes (even), stream
    "ptt_kv_ring_write": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, qw, scale, bias|NULL, out, M, N, K, x row stride, kind, token
    # tile, weight rows, splits, dtype, stream
    "ptt_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong,
                        _I, _I, _I, _I, _I, _P],
    # cudaError_t -> its name (returns a C string, not an error)
    "ptt_error_string": [_I],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper kernels "
            "of paddle_tpu_torch are built from csrc/*.cu on the machine "
            "with the card")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > t for s in _DEPS)


@contextlib.contextmanager
def _locked():
    """The exclusive file lock on ``BUILD_DIR/build.lock`` that every
    process and thread building into ``BUILD_DIR`` takes (released when
    the holder exits, however it exits)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile every source in parallel, link the shared library, return
    its path.  ``verbose`` adds ``-Xptxas -v`` and prints what ptxas says
    (registers, shared memory, spills per kernel).  Another process
    building into the same directory is waited for, and what it built is
    taken where it is fresh (``force`` builds again all the same)."""
    if not force and not _stale():
        return LIB_PATH
    with _locked():
        if not force and not _stale():
            return LIB_PATH
        return _compile_and_link(verbose)


def _compile_and_link(verbose: bool) -> str:
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src).replace(".cu", ".o"))
        cmd = [nvcc, *ARCH, *FLAGS, *extra, "-c", "-o", obj, src]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, _, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, end="")
        if p.returncode != 0:
            errors.append(f"{os.path.basename(src)}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = LIB_PATH + ".tmp"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp,
                           *[obj for _, obj, _ in procs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_char_p if name == "ptt_error_string"
                              else ctypes.c_int)
            _lib = so
        return _lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def f16_note(dtype: torch.dtype) -> str:
    """What a refusal of ``dtype`` adds for float16 (AMP's float16 reaches
    the kernels before they take it)."""
    return (" (float16 kernels are ROADMAP F16, not ported)"
            if dtype == torch.float16 else "")


def dtype_code(name: str, t: torch.Tensor) -> int:
    """The C entries' code for ``t``'s dtype (0 float32, 1 bfloat16)."""
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {t.dtype}{f16_note(t.dtype)}")
    return _DTYPE_CODES[t.dtype]


def launch_args(name: str, *tensors: torch.Tensor) -> Tuple[int, int]:
    """Check that ``tensors`` share one CUDA device and a kernel dtype;
    return (dtype code, current stream handle) for the C entry.  The
    caller launches inside ``device_guard(tensors[0])``."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: inputs must share one device and "
                             f"dtype, got {t.device}/{t.dtype} beside "
                             f"{dev}/{dt}")
    return dtype_code(name, tensors[0]), torch.cuda.current_stream(
        dev).cuda_stream


def launch_args_cached(name: str, q: torch.Tensor,
                       *caches: torch.Tensor) -> Tuple[int, int, int]:
    """``launch_args`` for a kernel over a cache whose dtype may differ from
    q's (K4 over a ``cache_dtype`` of its own): q on a CUDA device in a
    kernel dtype, the caches on q's device sharing a kernel dtype of their
    own.  Returns (q's dtype code, the caches' dtype code, current stream
    handle).  Every other kernel keeps ``launch_args``."""
    dt, stream = launch_args(name, q)
    cd = caches[0].dtype
    for t in caches:
        if t.device != q.device or t.dtype != cd:
            raise ValueError(f"{name}: the caches must share one dtype on "
                             f"q's device {q.device}, got {t.device}/"
                             f"{t.dtype} beside {q.device}/{cd}")
    return dt, dtype_code(name, caches[0]), stream


# the namespace of the kernels' ops (``torch.ops.paddle_tpu_torch``); the
# registrations live as long as this object
_OPS = torch.library.Library("paddle_tpu_torch", "FRAGMENT")


def kernel_op(schema: str, fake: Callable):
    """Decorator: define the op ``paddle_tpu_torch::<schema>`` with the
    decorated function as its implementation on every device
    (``CompositeExplicitAutograd``: the function takes the plain version
    for CPU tensors and launches the kernel for CUDA ones) and ``fake`` as
    its fake implementation (the output shapes and dtypes, for
    ``torch.export``); return the op.  A wrapper calls the op, so eager
    runs, CUDA graphs and exported programs take one path.  Not
    ``torch.library.custom_op``: its wrapper imports ``torch._dynamo``
    (sympy, DTensor) at each process's first call, seconds in every
    serving worker."""
    def register(impl):
        name = schema.split("(", 1)[0]
        _OPS.define(schema)
        _OPS.impl(name, impl, "CompositeExplicitAutograd")
        torch.library.register_fake(f"paddle_tpu_torch::{name}", fake,
                                    lib=_OPS)
        return getattr(torch.ops.paddle_tpu_torch, name).default
    return register


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper must record its backward: grad mode is on and an
    input requires grad.  Otherwise it launches its forward alone."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def device_guard(t: torch.Tensor):
    """Make ``t``'s card the current one for a launch (a no-op when it
    already is, the common case)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def check(err: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry.  An
    entry returns cudaErrorInvalidConfiguration for a shape whose block
    would need more shared memory than it may use (the device's opt-in
    limit for K4, B1, B2 and B8)."""
    if err != 0:
        what = lib().ptt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err} ({what})")
