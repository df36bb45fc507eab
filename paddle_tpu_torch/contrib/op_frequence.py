"""Op frequency statistics (counterpart of paddle_tpu/contrib/op_frequence.py;
fluid's contrib/op_frequence.py).

Counts single-op and adjacent-op-pair frequencies over a Program: what a
fused kernel would have to cover.
"""
from collections import Counter, OrderedDict

from ..framework import program as program_mod

__all__ = ["op_freq_statistic"]


def op_freq_statistic(program):
    """Return (uni_op_freq, adj_2_op_freq) as frequency-sorted
    OrderedDicts (ref op_frequence.py:23)."""
    if not isinstance(program, program_mod.Program):
        raise TypeError("'program' should be an instance of Program.")

    uni_op_freq = Counter()
    adj_2_op_freq = Counter()
    for block in program.blocks:
        op_in_block = len(block.ops)
        for i, op in enumerate(block.ops):
            uni_op_freq[op.type] += 1
            if i < op_in_block - 1:
                adj_2_op_freq["%s->%s" % (op.type,
                                          block.ops[i + 1].type)] += 1

    uni = OrderedDict(sorted(uni_op_freq.items(),
                             key=lambda x: (-x[1], x[0])))
    adj = OrderedDict(sorted(adj_2_op_freq.items(),
                             key=lambda x: (-x[1], x[0])))
    return uni, adj
