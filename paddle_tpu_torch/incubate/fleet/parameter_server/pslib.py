"""PSLib downpour surface (counterpart of paddle_tpu/incubate/fleet/
parameter_server/pslib.py; ref incubate/fleet/parameter_server/pslib/
__init__.py:28): it configures Baidu's parameter-server binary, which
the port does not have."""

__all__ = ["fleet"]

_MSG = ("PSLib/Downpour has no counterpart in paddle_tpu_torch: use "
        "layers.embedding(is_distributed=True) tables, trained "
        "synchronously")


class _PSLibStub(object):
    def __getattr__(self, name):
        raise NotImplementedError(_MSG)


fleet = _PSLibStub()
