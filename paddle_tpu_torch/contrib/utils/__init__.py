"""fluid.contrib.utils (counterpart of paddle_tpu/contrib/utils/;
reference contrib/utils/: hdfs_utils and lookup_table_utils)."""
from . import hdfs_utils  # noqa: F401
from . import lookup_table_utils  # noqa: F401
from .hdfs_utils import HDFSClient, multi_download, multi_upload  # noqa: F401

__all__ = ["HDFSClient", "multi_download", "multi_upload"]
