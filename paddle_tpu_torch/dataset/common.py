"""Dataset cache helpers. Counterpart of paddle_tpu/dataset/common.py
(parity: python/paddle/dataset/common.py). ``download`` never opens a
connection: it returns a file already in place, or raises naming it."""
import hashlib
import os

from ._synth import DATA_HOME

__all__ = ['DATA_HOME', 'data_home', 'cached_path', 'download', 'md5file']


def data_home():
    """Cache root, re-read from the environment on every call (tests and
    multi-corpus setups repoint PADDLE_TPU_TORCH_DATA_HOME at runtime)."""
    return os.environ.get('PADDLE_TPU_TORCH_DATA_HOME', DATA_HOME)


def file_key(path):
    """(path, mtime_ns, size): parse-memo key that invalidates when the
    cached file is replaced in place."""
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


def cached_path(module_name, filename, md5sum=None):
    """Path of a cached corpus file in the reference layout
    (<data_home>/<module>/<file>), or None when absent/corrupt. The
    real-data parsers probe this and fall back to synthetic corpora."""
    path = os.path.join(data_home(), module_name, filename)
    if os.path.exists(path) and (md5sum is None or
                                 md5file(path) == md5sum):
        return path
    return None


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """The path of ``url``'s file under the data home, if it is already
    there (a checksum mismatch warns: nothing can fetch it again);
    otherwise raises, naming the file to place. Opens no connection."""
    dirname = os.path.join(data_home(), module_name)
    filename = os.path.join(
        dirname, url.split('/')[-1] if save_name is None else save_name)
    if os.path.exists(filename):
        if md5sum is not None and md5file(filename) != md5sum:
            import warnings
            warnings.warn("serving %s despite an md5 mismatch (nothing "
                          "downloads it again)" % filename)
        return filename
    raise RuntimeError(
        "paddle_tpu_torch downloads nothing: %s is not in place. Put the "
        "file at %s or use the synthetic dataset fallback."
        % (url, filename))
