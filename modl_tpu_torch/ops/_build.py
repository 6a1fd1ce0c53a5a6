"""Build the port's CUDA sources into one shared library.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
``build/modl_tpu_torch/`` beside the package (git ignores it), named by a
hash of the sources, the headers they share (``csrc/*.cuh``) and flags:
a source change triggers a rebuild, an unchanged tree reuses the
library. Each source compiles in its own
``nvcc`` process, all started together, and one more links them. The
sources expose plain C entry points, so the library needs no PyTorch
headers and is loaded once with ``ctypes`` (:func:`load`); each
kernel's wrapper declares the signature of its own entry point. The
compiler's resource report (``-Xptxas -v``) is kept beside the library
as ``<name>.log``.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'modl_tpu_torch'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = [*ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']


def _nvcc():
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    for cand in (Path(home) / 'bin' / 'nvcc', shutil.which('nvcc')):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def sources():
    return sorted(SRC_DIR.glob('*.cu'))


def library_path():
    """Path the library for the current sources is built to."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources() + sorted(SRC_DIR.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libmodl_tpu_torch_{h.hexdigest()[:16]}.so'


def build():
    """Return the library for the current sources, compiling it first
    when it does not exist yet."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{out.stem}.{os.getpid()}'
    objs = [BUILD_DIR / f'{tag}.{src.stem}.o' for src in sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    try:
        failed = [src.name for src, proc in zip(sources(), procs)
                  if proc.returncode != 0]
        if not failed:
            res = subprocess.run([_nvcc(), *ARCH, '-shared', '-o', str(tmp),
                                  *map(str, objs)], capture_output=True,
                                 text=True)
            logs.append(res.stdout + res.stderr)
            if res.returncode != 0:
                failed = ['link']
        out.with_suffix('.log').write_text(''.join(logs))
        if failed:
            raise RuntimeError(f'nvcc failed ({", ".join(failed)}):\n'
                               + ''.join(logs))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.cache
def load():
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build()))


def entry(name, argtypes, restype=ctypes.c_int):
    """Entry point ``name`` of the library with its C signature set (a
    kernel's entry point returns a cudaError_t as an int)."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn
