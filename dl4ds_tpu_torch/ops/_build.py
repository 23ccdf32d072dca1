"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each source under `dl4ds_tpu_torch/csrc/` compiles, on first use, into a
shared library with a plain C interface under `build/kernels/` at the root
of the checkout (git-ignored). The library's file name carries a hash of its
source and of the shared headers (`csrc/*.cuh`), so an edited source or
header is rebuilt and a stale build is never loaded.
There is no fallback: a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ['SOURCES', 'BUILD_DIR', 'build_all', 'load']

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'

# kernel library name -> its source in csrc/
SOURCES = {'channel_attention': 'channel_attention.cu',
           'conv_int8': 'conv_int8.cu',
           'convlstm': 'convlstm.cu',
           'convlstm_bwd': 'convlstm_bwd.cu',
           'convlstm_seq': 'convlstm_seq.cu',
           'ssim': 'ssim.cu'}

NVCC_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [Path(cuda_home) / 'bin' / 'nvcc'] if cuda_home else []
    found = shutil.which('nvcc')
    if found:
        candidates.append(Path(found))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels cannot be built')


def lib_path(name):
    """The library's path, named by a hash of its source, of every header
    under csrc/ (the sources include them) and of the compiler flags."""
    parts = [(CSRC_DIR / SOURCES[name]).read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC_DIR.glob('*.cuh'))]
    digest = hashlib.sha256(b''.join(parts)
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build_all(names=None):
    """Compile every kernel library not built yet, one `nvcc` per source,
    all started together. Returns {name: (seconds, compiler output)} for the
    libraries built by this call."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name} (nvcc exit {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError('kernel build failed: ' + '\n'.join(failed))
    return report


def load(name):
    """The loaded ctypes library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
