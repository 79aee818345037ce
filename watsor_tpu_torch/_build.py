"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one self-contained ``csrc/<name>.cu`` with a plain C
interface. ``load(name)`` compiles it with ``nvcc`` for ``sm_90a`` into
``build/watsor_tpu_torch/`` beside the package, keyed on a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. Nothing is built when a module is imported: only a wrapper that is
about to launch a kernel on a CUDA tensor calls ``load``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'watsor_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()          # guards the two dicts
_libs = {}
_build_locks = {}                 # one per library: a build runs once


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA '
                           'kernels of watsor_tpu_torch are built at first '
                           'use')
    return found


def _library_path(name, source):
    """Where ``source`` builds to for its current text."""
    with open(source, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, '{}-{}.so'.format(
        name, digest.hexdigest()[:16]))


def load(name, signatures, source=None):
    """The ctypes library of ``csrc/<name>.cu``, built if not yet built.
    ``signatures`` maps each C entry point to its argument types; every
    entry point returns a CUDA error code. ``source`` builds another file
    in its place (another tree's version of the kernel, for A/B runs).
    Builds of different libraries may run at once, from different
    threads."""
    source = os.path.abspath(source or os.path.join(CSRC_DIR, name + '.cu'))
    key = (name, source)
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        build_lock = _build_locks.setdefault(key, threading.Lock())
    with build_lock:
        with _lock:
            lib = _libs.get(key)
        if lib is not None:
            return lib
        path = _library_path(name, source)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '{}.{}.{}.tmp'.format(path, os.getpid(),
                                        threading.get_ident())
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, source],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed for {}:\n{}{}'.format(
                    source, proc.stdout, proc.stderr))
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for symbol, argtypes in signatures.items():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        with _lock:
            _libs[key] = lib
        return lib


def check(err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError('{} failed: CUDA error {}'.format(what, err))
