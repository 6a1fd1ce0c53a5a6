"""Caching fixes for NIfTI images (counterpart of
``modl_tpu/input_data/fmri/fixes.py``).

Records stored as ``.npy`` paths are cheap to hash already; NIfTI
images, where nibabel and nilearn are installed, are not. This module
gives them the same treatment as the JAX package does:

- ``filename_mtime_token``: the (path, mtime, size) identity of a file,
  which keys caches on the file instead of its content;
- ``get_picklable_nifti_classes``: a ``Nifti1Image`` subclass whose
  pickle carries dataobj/header/affine/extra/filename, and a ``load``
  that upgrades loaded images to it;
- ``monkey_patch_nifti_image``: replaces ``joblib.hashing.hash`` (and
  ``joblib.memory``'s binding of it) with a hash that takes a file-backed
  ``Nifti1Image`` by its token, and routes ``nibabel.load`` through the
  picklable class;
- ``monkey_patch_nilearn_caching``: the same for nilearn's own loader,
  and its version-skew cache wipe replaced by a plain ``memory.cache``.

nibabel, nilearn and joblib are imported inside the functions: without
them each function returns what the JAX one returns (None or False).
The patches are process-wide. The picklable class is published as this
module's ``Nifti1Image``, so pickles of the port's images load in the
port and not in the JAX package, and the other way round.
"""
import os

__all__ = ["filename_mtime_token", "get_picklable_nifti_classes",
           "monkey_patch_nifti_image", "monkey_patch_nilearn_caching"]


_PICKLABLE_CACHE = None


def get_picklable_nifti_classes():
    """(Nifti1Image subclass, load function) that survive pickling, or
    None without nibabel.

    nibabel's ``Nifti1Image`` drops its filename (and may hold an open
    memory map) across pickling; the subclass serialises
    dataobj/header/affine/extra/filename explicitly. It is created once
    and published as this module's ``Nifti1Image`` attribute: pickle
    finds classes by module and qualified name.
    """
    global _PICKLABLE_CACHE
    if _PICKLABLE_CACHE is not None:
        return _PICKLABLE_CACHE
    try:
        import nibabel
    except ImportError:
        return None

    import numpy as np

    class Nifti1Image(nibabel.Nifti1Image):
        def __getstate__(self):
            return {'dataobj': np.asanyarray(self._dataobj),
                    'header': self.header,
                    'affine': self.affine,
                    'extra': self.extra,
                    'filename': self.get_filename()}

        def __setstate__(self, state):
            fresh = Nifti1Image(dataobj=state['dataobj'],
                                affine=state['affine'],
                                header=state['header'],
                                extra=state['extra'])
            self.__dict__ = fresh.__dict__
            if state['filename'] is not None:
                self.set_filename(state['filename'])

    Nifti1Image.__module__ = __name__
    Nifti1Image.__qualname__ = 'Nifti1Image'
    globals()['Nifti1Image'] = Nifti1Image

    nibabel_load = nibabel.load

    def load(filename, **kwargs):
        img = nibabel_load(filename, **kwargs)
        if type(img) is nibabel.Nifti1Image:
            img.__class__ = Nifti1Image
        return img

    _PICKLABLE_CACHE = (Nifti1Image, load)
    return _PICKLABLE_CACHE


def filename_mtime_token(path):
    """Cache-identity token for a data file: (path, mtime, size)."""
    st = os.stat(path)
    return (os.path.abspath(path), st.st_mtime, st.st_size)


def monkey_patch_nifti_image():
    """Hash file-backed NIfTI images in joblib by their (filename, mtime,
    size) token and load them as the picklable class. Returns False
    (and patches nothing) without nibabel or joblib."""
    try:
        import nibabel
        from joblib import hashing
    except ImportError:
        return False

    base_cls = getattr(hashing, 'NumpyHasher', hashing.Hasher)

    class NibabelHasher(base_cls):
        def save(self, obj):
            if isinstance(obj, nibabel.Nifti1Image):
                filename = obj.get_filename()
                if filename is not None:
                    obj = ('__nifti_token__',
                           filename_mtime_token(filename))
            base_cls.save(self, obj)

    def nifti_hash(obj, hash_name='md5', coerce_mmap=False):
        try:
            hasher = NibabelHasher(hash_name=hash_name,
                                   coerce_mmap=coerce_mmap)
        except TypeError:  # a plain Hasher takes no coerce_mmap
            hasher = NibabelHasher(hash_name=hash_name)
        return hasher.hash(obj)

    hashing.hash = nifti_hash
    # joblib.memory binds `hash` by a from-import when it loads: rebind it
    from joblib import memory as joblib_memory
    if hasattr(joblib_memory, 'hash'):
        joblib_memory.hash = nifti_hash
    classes = get_picklable_nifti_classes()
    if classes is not None:
        nibabel.load = classes[1]
    return True


def monkey_patch_nilearn_caching():
    """:func:`monkey_patch_nifti_image`, then nilearn's two own holes:

    - ``nilearn._utils.niimg.load_niimg`` builds images from its input's
      class, not through ``nibabel.load``: it is wrapped so that every
      image entering a masker becomes the picklable class;
    - ``nilearn._utils.cache_mixin._safe_cache`` wipes the cache
      directory when the nibabel version changes: it becomes a plain
      ``memory.cache`` (the (filename, mtime, size) token does not depend
      on that version).

    Returns True when the patches were applied, False without nilearn or
    nibabel.
    """
    if not monkey_patch_nifti_image():
        return False
    try:
        from nilearn._utils import cache_mixin, niimg
    except ImportError:
        return False

    classes = get_picklable_nifti_classes()
    if classes is None:
        return False
    picklable_cls = classes[0]

    inner_load = niimg.load_niimg

    def load_niimg(niimg_in, dtype=None):
        import nibabel
        img = inner_load(niimg_in, dtype=dtype)
        if type(img) is nibabel.Nifti1Image:
            img.__class__ = picklable_cls
        return img

    niimg.load_niimg = load_niimg

    if hasattr(cache_mixin, '_safe_cache'):
        def _safe_cache(memory, func, **kwargs):
            # the same contract, without the version-skew cache wipe
            return memory.cache(func, **kwargs)

        cache_mixin._safe_cache = _safe_cache
    return True
