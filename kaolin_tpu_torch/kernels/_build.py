"""Builds ``kaolin_tpu_torch/csrc/*.cu`` with ``nvcc`` and loads them with
``ctypes``.

Each source is compiled on its own into a shared library with a plain C
interface, named by a hash of the source and the flags, under
``kaolin_tpu_torch/_build/`` (listed in ``.gitignore``). A library that is
already there is loaded as it is. ``build_all`` starts one ``nvcc`` per
source, all at once.

The flags keep the kernels' arithmetic equal to the plain PyTorch versions:
``--fmad=false`` stops ``nvcc`` from contracting ``a*b+c`` into one fused
multiply-add (which would round once where PyTorch rounds twice and flip
inside tests and near-ties on edge pixels), and no fast-math flag is given,
so division and square root stay IEEE-rounded.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ['SOURCES', 'build_all', 'load', 'launch', 'cuda_inputs',
           'check_shapes', 'pixel_scale']

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / 'csrc'
_BUILD_DIR = _PKG / '_build'
SOURCES = ('rasterize', 'rasterize_bwd', 'soft_mask', 'grid_sample',
           'nn_distance', 'p2m_distance')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC')

_loaded = {}


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin and PATH); the CUDA kernels '
                           'of kaolin_tpu_torch are built with it at first '
                           'use')
    return found


def _target(name):
    src = _CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return src, _BUILD_DIR / f'{name}-{digest[:16]}.so'


def _start(name):
    """Starts ``nvcc`` for one source; returns (process, tmp, out) or None
    when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name, job):
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu:\n'
                           f'{log.decode(errors="replace")}')
    os.replace(tmp, out)


def build_all():
    """Builds every kernel source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    return time.perf_counter() - t0


def load(name, signatures):
    """The ``ctypes`` library built from ``csrc/<name>.cu``, built first if
    needed. ``signatures`` maps each C entry point to its argument types;
    every entry point returns a ``cudaError_t`` as an int."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)[1]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def launch(lib, fn, *args):
    """Calls a C entry point and raises if it reports a CUDA error."""
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f'{fn}: CUDA error {err} at launch')


def cuda_inputs(fn, floats, ints=()):
    """Checks the tensors a kernel takes: all on one CUDA device, ``floats``
    float32 and ``ints`` int32. Returns (contiguous floats, contiguous ints,
    device index, stream handle)."""
    device = floats[0].device
    for t in (*floats, *ints):
        if t.device != device:
            raise ValueError(f'{fn}: tensors on {device} and {t.device}')
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f'{fn}: the CUDA kernel takes float32, '
                            f'got {t.dtype}')
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f'{fn}: the CUDA kernel takes int32 indices, '
                            f'got {t.dtype}')
    stream = torch.cuda.current_stream(device).cuda_stream
    return ([t.contiguous() for t in floats], [t.contiguous() for t in ints],
            device.index, stream)


def check_shapes(fn, *pairs):
    """Raises unless each tensor of (tensor, shape, tensor, shape, ...) has
    its shape."""
    for t, shape in zip(pairs[::2], pairs[1::2]):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{fn}: expected shape {tuple(shape)}, got '
                             f'{tuple(t.shape)}')


def pixel_scale(multiplier, size):
    """``multiplier / size`` formed in double and rounded to float32, as the
    JAX package forms the pixel-centre scale at float32."""
    return ctypes.c_float(multiplier / size)
