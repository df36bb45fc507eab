"""Dataset cache / download plumbing (counterpart of
paddle_tpu/dataset/common.py; ref python/paddle/dataset/common.py).

The reference downloads public corpora into ``~/.cache/paddle/dataset``.
Here :func:`download` only ever *resolves* files: an already-cached file
(placed there by the user or a mirror job) is returned, a missing one
raises a clear error instead of attempting a network fetch. The corpus
modules of this package ship deterministic synthetic generators with
the reference's record schemas (the JAX package's, sample for sample),
so scripts written against ``paddle.dataset.*`` run unmodified; point
``PADDLE_TPU_DATASET_ROOT`` at a real mirror to swap in genuine
payloads where a module supports it.
"""
import errno
import glob
import hashlib
import os
import pickle

__all__ = [
    'DATA_HOME', 'download', 'md5file', 'split', 'cluster_files_reader',
]

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATASET_ROOT",
    os.path.expanduser(os.path.join('~', '.cache', 'paddle_tpu', 'dataset')))


def must_mkdirs(path):
    try:
        os.makedirs(path)
    except OSError as exc:
        if exc.errno != errno.EEXIST:
            raise


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve a dataset file in the local cache; never hits the network.

    Returns the cached path if present (md5 verified when ``md5sum`` is
    given); raises ``RuntimeError`` otherwise — this environment has no
    egress, so fetching is the operator's job, not the framework's.
    """
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, url.split('/')[-1] if save_name is None else save_name)
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise RuntimeError(
                "cached file %s exists but its md5 does not match %s" %
                (filename, md5sum))
        return filename
    raise RuntimeError(
        "dataset file %s is not in the local cache (%s) and this "
        "environment has no network egress; mirror it there manually or "
        "use the synthetic readers in paddle_tpu_torch.dataset.*" %
        (url.split('/')[-1], dirname))


def fetch_all():
    """Materialize every synthetic corpus cache (parity with the
    reference's paddle.dataset.common.fetch_all crawler)."""
    import importlib
    for name in ('mnist', 'cifar', 'uci_housing', 'imdb', 'imikolov',
                 'movielens', 'conll05', 'sentiment', 'wmt14', 'wmt16',
                 'flowers', 'mq2007'):
        mod = importlib.import_module('paddle_tpu_torch.dataset.' + name)
        if hasattr(mod, 'fetch'):
            mod.fetch()


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Shard a reader's samples into files of ``line_count`` records each
    (ref common.py:128)."""
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
                lines = []
                indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Round-robin shard reader over files matching ``files_pattern``
    (ref common.py:166): trainer ``i`` of ``n`` reads every n-th file."""

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        my_file_list = [
            fn for idx, fn in enumerate(file_list)
            if idx % trainer_count == trainer_id
        ]
        for fn in my_file_list:
            with open(fn, "rb") as f:
                for line in loader(f):
                    yield line

    return reader
