"""paddle.compat parity (counterpart of paddle_tpu/compat.py; ref
python/paddle/compat.py). The reference
papered over py2/py3; on py3-only these are mostly identities, kept so
ported call sites resolve."""
import math

__all__ = ["long_type", "to_text", "to_bytes", "round",
           "floor_division", "get_exception_message"]

long_type = int   # py2 long width handling (reference compat.py)


def _convert(obj, conv, inplace):
    if obj is None:
        return obj
    if isinstance(obj, dict):
        # keys AND values convert (reference to_text/to_bytes dict path)
        items = {_convert(k, conv, False): _convert(v, conv, False)
                 for k, v in obj.items()}
        if inplace:
            obj.clear()
            obj.update(items)
            return obj
        return items
    if isinstance(obj, (list, set)):
        if inplace:
            items = [_convert(i, conv, False) for i in obj]
            obj.clear()
            (obj.extend if isinstance(obj, list) else obj.update)(items)
            return obj
        return type(obj)(_convert(i, conv, False) for i in obj)
    return conv(obj)


def to_text(obj, encoding="utf-8", inplace=False):
    # non-bytes scalars pass through UNCHANGED (reference py3 behavior:
    # only bytes decode; numbers/bools keep their types)
    def conv(o):
        return o.decode(encoding) if isinstance(o, bytes) else o
    return _convert(obj, conv, inplace)


def to_bytes(obj, encoding="utf-8", inplace=False):
    def conv(o):
        return o if isinstance(o, bytes) else str(o).encode(encoding)
    return _convert(obj, conv, inplace)


def round(x, d=0):
    """Python-2-style half-away-from-zero rounding (the reference keeps
    this semantic difference from py3 banker's rounding)."""
    p = 10 ** d
    if x > 0:
        return float(math.floor((x * p) + math.copysign(0.5, x))) / p
    if x < 0:
        return float(math.ceil((x * p) + math.copysign(0.5, x))) / p
    return 0.0


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    return str(exc)
