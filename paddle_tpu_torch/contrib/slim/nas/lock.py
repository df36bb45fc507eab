"""File locks for NAS checkpoint coordination (counterpart of
paddle_tpu/contrib/slim/nas/lock.py; reference slim/nas/lock.py)."""
import os

__all__ = ["lock", "unlock"]

if os.name == "posix":
    import fcntl

    def lock(file_handle):
        """Block until an exclusive lock on the open file is held."""
        fcntl.flock(file_handle, fcntl.LOCK_EX)

    def unlock(file_handle):
        fcntl.flock(file_handle, fcntl.LOCK_UN)
else:  # pragma: no cover - windows parity stub
    def lock(file_handle):
        raise NotImplementedError("file locks require posix")

    def unlock(file_handle):
        raise NotImplementedError("file locks require posix")
