"""Placeholder for the reference's generated pserver protobuf module
(counterpart of paddle_tpu/distributed/ps_pb2.py; ref fluid/distributed/
ps_pb2.py, generated from ps.proto). The port has no pserver wire
protocol; anything touching it raises with the alternative named."""

__all__ = []

_GUIDANCE = (
    "ps_pb2 is the reference pserver's wire protocol; paddle_tpu_torch "
    "has no pserver tier: sparse tables are embeddings marked "
    "is_distributed=True")


def __getattr__(name):
    if name.startswith("__"):        # import-machinery dunder probes
        raise AttributeError(name)
    raise NotImplementedError(_GUIDANCE)
