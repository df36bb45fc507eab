"""fluid.layers.utils (counterpart of paddle_tpu/layers/utils.py): the
nest utilities, plus convert_to_list."""
import collections

__all__ = ["convert_to_list", "is_sequence", "flatten",
           "pack_sequence_as", "map_structure", "assert_same_structure"]


def convert_to_list(value, n, name, dtype=int):
    if isinstance(value, dtype):
        return [value] * n
    try:
        value_list = list(value)
    except TypeError:
        raise ValueError("The %s's type must be %s or list of %s" %
                         (name, dtype, dtype))
    if len(value_list) != n:
        raise ValueError("The %s's length must be %d" % (name, n))
    for v in value_list:
        if not isinstance(v, dtype):
            raise ValueError("The %s's type must be a list of %s" %
                             (name, dtype))
    return value_list


def is_sequence(seq):
    return isinstance(seq, collections.abc.Sequence) and \
        not isinstance(seq, str) or isinstance(seq, dict)


def _yield_flat(nest):
    if isinstance(nest, dict):
        for k in sorted(nest):
            for v in _yield_flat(nest[k]):
                yield v
    elif is_sequence(nest):
        for item in nest:
            for v in _yield_flat(item):
                yield v
    else:
        yield nest


def flatten(nest):
    return list(_yield_flat(nest)) if is_sequence(nest) else [nest]


def _pack(structure, flat, index):
    if isinstance(structure, dict):
        out = {}
        for k in sorted(structure):
            out[k], index = _pack(structure[k], flat, index)
        return type(structure)(out), index
    if is_sequence(structure):
        items = []
        for s in structure:
            item, index = _pack(s, flat, index)
            items.append(item)
        if isinstance(structure, tuple):
            if hasattr(structure, "_fields"):            # namedtuple
                return type(structure)(*items), index
            return tuple(items), index
        return type(structure)(items), index
    return flat[index], index + 1


def pack_sequence_as(structure, flat_sequence):
    if not is_sequence(structure):
        if len(flat_sequence) != 1:
            raise ValueError("structure is a scalar but there are %d "
                             "flat values" % len(flat_sequence))
        return flat_sequence[0]
    packed, used = _pack(structure, list(flat_sequence), 0)
    if used != len(flat_sequence):
        raise ValueError("could not pack %d values into the structure"
                         % len(flat_sequence))
    return packed


def map_structure(func, *structures):
    flats = [flatten(s) for s in structures]
    results = [func(*xs) for xs in zip(*flats)]
    return pack_sequence_as(structures[0], results)


def _same(a, b, check_types):
    if is_sequence(a) != is_sequence(b):
        raise ValueError("structures differ: %r vs %r" % (a, b))
    if not is_sequence(a):
        return
    if check_types and type(a) is not type(b) and not (
            hasattr(a, "_fields") and hasattr(b, "_fields") and
            type(a) is type(b)):
        raise ValueError("structure container types differ: %s vs %s"
                         % (type(a).__name__, type(b).__name__))
    if isinstance(a, dict) != isinstance(b, dict):
        raise ValueError("structures differ: %r vs %r" % (a, b))
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise ValueError("dict keys differ: %r vs %r" % (a, b))
        for k in a:
            _same(a[k], b[k], check_types)
        return
    if len(a) != len(b):
        raise ValueError("lengths differ: %d vs %d" % (len(a), len(b)))
    for x, y in zip(a, b):
        _same(x, y, check_types)


def assert_same_structure(nest1, nest2, check_types=True):
    _same(nest1, nest2, check_types)
