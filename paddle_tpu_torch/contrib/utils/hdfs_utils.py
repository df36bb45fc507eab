"""fluid.contrib.utils.hdfs_utils (counterpart of paddle_tpu/contrib/
utils/hdfs_utils.py; reference contrib/utils/hdfs_utils.py:35).

The reference shells out to a Hadoop CLI to stage data and checkpoints
on a distributed file system. The port has no HDFS staging: mount the
storage as a POSIX path and point save/load and the Dataset APIs at it.
These names raise with that guidance rather than half-working.
"""

__all__ = ["HDFSClient", "multi_download", "multi_upload"]

_MSG = ("HDFS staging is not available in paddle_tpu_torch: mount the "
        "storage as a POSIX path and point save/load and the Dataset "
        "APIs at that path directly.")


class HDFSClient(object):
    def __init__(self, hadoop_home=None, configs=None):
        raise NotImplementedError(_MSG)


def multi_download(*args, **kwargs):
    raise NotImplementedError(_MSG)


def multi_upload(*args, **kwargs):
    raise NotImplementedError(_MSG)
