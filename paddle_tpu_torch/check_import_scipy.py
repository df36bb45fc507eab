"""paddle.check_import_scipy (counterpart of paddle_tpu/
check_import_scipy.py; ref python/paddle/check_import_scipy.py): a
Windows-only scipy DLL probe."""

__all__ = ["check_import_scipy"]


def check_import_scipy(OsName):
    """On Windows ('nt') check that scipy.io imports, naming the usual
    missing-VC++-runtime cause; nothing elsewhere."""
    if OsName != "nt":
        return
    try:
        import scipy.io  # noqa: F401
    except ImportError as e:
        raise ImportError(
            str(e) + "\nscipy.io failed to import on Windows — usually a "
            "missing Visual C++ runtime; install the MSVC redistributable "
            "and retry")
