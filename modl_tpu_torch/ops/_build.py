"""Build the port's CUDA sources into one shared library.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
``build/modl_tpu_torch/`` beside the package (git ignores it), named by a
hash of the sources and flags: a source change triggers a rebuild, an
unchanged tree reuses the library. The sources expose plain C entry
points, so the library needs no PyTorch headers and is loaded with
``ctypes`` (``ops/bcd.py``). The compiler's resource report
(``-Xptxas -v``) is kept beside the library as ``<name>.log``.
"""
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'modl_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


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
    for src in sources():
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
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix('.log').write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError('nvcc failed:\n' + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out
