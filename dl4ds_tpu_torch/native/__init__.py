"""
ctypes bindings of the host gather/crop kernels (`dl4ds_host.cpp`, the
port's copy of the JAX package's `dl4ds_tpu/native/`), which the
streaming data tier (`dataloader.HostStreamer`) assembles each batch with.

The library is built on first use with `g++ -O3 -march=native -fopenmp`
into `build/host/` at the root of the checkout (git-ignored), never beside
its source. Its file name carries a hash of the source, of the compiler
flags and of the host CPU's flags: a `-march=native` build run on another
CPU dies with SIGILL, which nothing can catch, so another CPU builds its
own. There is no fallback: a failed build raises, as the CUDA kernels'
does (`ops/_build.py`). Each function has a plain numpy version
(`*_reference`), the tests' oracle.

Each function writes into `out` when it is given, a C-contiguous float32
array of the output's shape (a pinned host slot's `.numpy()`), so that no
pageable intermediate lies between the gather and the copy to the card.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ['available', 'gather_windows', 'crop_batch', 'gather_crop',
           'gather_windows_reference', 'crop_batch_reference',
           'gather_crop_reference', 'BUILD_DIR']

SOURCE = Path(__file__).resolve().parent / 'dl4ds_host.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'host'
CXX_FLAGS = ['-O3', '-march=native', '-fopenmp', '-shared', '-fPIC']

_I64P = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
_F32P = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
_I64 = ctypes.c_int64

_lock = threading.Lock()
_lib = None


def _cpu_flags():
    """The host CPU's feature flags (/proc/cpuinfo), else its name."""
    try:
        with open('/proc/cpuinfo') as fh:
            for line in fh:
                if line.startswith('flags'):
                    return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def lib_path():
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join(CXX_FLAGS).encode()
                            + _cpu_flags().encode()).hexdigest()[:16]
    return BUILD_DIR / f'libdl4ds_host-{digest}.so'


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: another process never
    # loads half a file
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = ['g++', *CXX_FLAGS, str(SOURCE), '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError('g++ not found: the native host gather/crop '
                           'cannot be built') from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'native host gather/crop build failed (g++ exit '
                           f'{proc.returncode}):\n{proc.stderr[-2000:]}')
    os.replace(tmp, out)


def _load():
    """The loaded library, built first if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.gather_windows_f32.argtypes = [_F32P, _I64P, _I64, _I64, _I64,
                                               _F32P]
            lib.crop_batch_f32.argtypes = [_F32P, _I64, _I64, _I64, _I64,
                                           _I64, _I64P, _I64P, _I64, _F32P]
            lib.gather_crop_f32.argtypes = [_F32P, _I64P, _I64, _I64, _I64,
                                            _I64, _I64, _I64P, _I64P, _I64,
                                            _F32P]
            for fn in (lib.gather_windows_f32, lib.crop_batch_f32,
                       lib.gather_crop_f32):
                fn.restype = None
            _lib = lib
        return _lib


def available():
    """True when the library builds (or was built) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _check_bounds(n, h, w, idx, ys, xs, patch, time_window):
    """The C loops check nothing: windows and crop origins out of range
    raise here, as numpy's indexing would, instead of reading past the
    source."""
    if idx is not None and idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi + time_window > n:
            raise IndexError(
                f'window indices [{lo}, {hi}] + time_window={time_window} '
                f'out of bounds for {n} samples')
    for name, v, limit in (('ys', ys, h), ('xs', xs, w)):
        if v is not None and v.size:
            lo, hi = int(v.min()), int(v.max())
            if lo < 0 or hi + patch > limit:
                raise IndexError(
                    f'{name} crop origins [{lo}, {hi}] + patch={patch} out '
                    f'of bounds for size {limit}')


def _out(out, shape):
    """`out` checked as a C-contiguous float32 array of `shape`, or a new
    one."""
    if out is None:
        return np.empty(shape, np.float32)
    if (out.dtype != np.float32 or tuple(out.shape) != tuple(shape)
            or not out.flags['C_CONTIGUOUS']):
        raise ValueError(f'`out` must be a C-contiguous float32 array of '
                         f'shape {tuple(shape)}, got {out.dtype} '
                         f'{tuple(out.shape)}')
    return out


def _src(src):
    # a contiguous float32 array (an np.memmap too) passes through without
    # a copy: the disk tier reads only the pages of the patches
    return np.ascontiguousarray(src, np.float32)


def _window_shape(b, time_window, rest):
    return (b,) + ((time_window,) if time_window > 1 else ()) + tuple(rest)


def gather_windows(src, idx, time_window=1, out=None):
    """out[i] = src[idx[i] : idx[i] + time_window] for src [N, ...]:
    [B, time_window, ...], the window axis dropped when time_window is
    1."""
    src = _src(src)
    idx = np.ascontiguousarray(idx, np.int64)
    b = idx.shape[0]
    lib = _load()
    _check_bounds(src.shape[0], None, None, idx, None, None, 0, time_window)
    out = _out(out, _window_shape(b, time_window, src.shape[1:]))
    lib.gather_windows_f32(src.reshape(-1), idx, b, time_window,
                           int(np.prod(src.shape[1:])), out.reshape(-1))
    return out


def crop_batch(src, ys, xs, patch, out=None):
    """Square crops of src [B, (T,) H, W, C] at the per-sample origins
    (ys[i], xs[i]): [B, (T,) patch, patch, C]."""
    src = _src(src)
    ys = np.ascontiguousarray(ys, np.int64)
    xs = np.ascontiguousarray(xs, np.int64)
    spatial = src.ndim == 4
    b, t, h, w, c = (src[:, None] if spatial else src).shape
    lib = _load()
    _check_bounds(b, h, w, None, ys, xs, patch, 1)
    out = _out(out, (b,) + (() if spatial else (t,)) + (patch, patch, c))
    lib.crop_batch_f32(src.reshape(-1), b, t, h, w, c, ys, xs, patch,
                       out.reshape(-1))
    return out


def gather_crop(src, idx, ys, xs, patch, time_window=1, out=None):
    """The window gather and the crop in one pass from src [N, H, W, C]:
    out[i] = src[idx[i] : idx[i] + time_window, ys[i] : ys[i] + patch,
    xs[i] : xs[i] + patch], [B, (time_window,) patch, patch, C]."""
    src = _src(src)
    idx = np.ascontiguousarray(idx, np.int64)
    ys = np.ascontiguousarray(ys, np.int64)
    xs = np.ascontiguousarray(xs, np.int64)
    b = idx.shape[0]
    n, h, w, c = src.shape
    lib = _load()
    _check_bounds(n, h, w, idx, ys, xs, patch, time_window)
    out = _out(out, _window_shape(b, time_window, (patch, patch, c)))
    lib.gather_crop_f32(src.reshape(-1), idx, b, time_window, h, w, c, ys,
                        xs, patch, out.reshape(-1))
    return out


def gather_windows_reference(src, idx, time_window=1):
    """`gather_windows` in numpy."""
    src = np.asarray(src, np.float32)
    win = np.asarray(idx, np.int64)[:, None] + np.arange(time_window)
    out = src[win]
    return out[:, 0] if time_window == 1 else out


def crop_batch_reference(src, ys, xs, patch):
    """`crop_batch` in numpy."""
    src = np.asarray(src, np.float32)
    return np.stack([s[..., y:y + patch, x:x + patch, :]
                     for s, y, x in zip(src, ys, xs)])


def gather_crop_reference(src, idx, ys, xs, patch, time_window=1):
    """`gather_crop` in numpy."""
    out = np.stack([np.asarray(src[i:i + time_window, y:y + patch,
                                   x:x + patch, :], np.float32)
                    for i, y, x in zip(idx, ys, xs)])
    return out[:, 0] if time_window == 1 else out
