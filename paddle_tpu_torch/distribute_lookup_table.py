"""fluid.distribute_lookup_table (counterpart of paddle_tpu/
distribute_lookup_table.py; ref
python/paddle/fluid/distribute_lookup_table.py): locate the distributed
embedding table a program uses (is_distributed lookup_table ops)."""

LOOKUP_TABLE_TYPE = "lookup_table"

__all__ = ["find_distributed_lookup_table",
           "find_distributed_lookup_table_inputs",
           "find_distributed_lookup_table_outputs"]


def find_distributed_lookup_table(program):
    table_name = None
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and \
                op.attr("is_distributed") is True:
            w = op.input("W")[0]
            if table_name is None:
                table_name = w
            elif table_name != w:
                raise RuntimeError("all distributed lookup_table_ops "
                                   "should have only one table")
        elif op.type == LOOKUP_TABLE_TYPE:
            if table_name == (op.input("W") or [None])[0]:
                raise RuntimeError("lookup_table_ops on the same table "
                                   "must all be distributed")
    return table_name


def find_distributed_lookup_table_inputs(program, table_name):
    ins = []
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and \
                table_name == op.input("W")[0]:
            ins.extend(op.input("Ids"))
    return ins


def find_distributed_lookup_table_outputs(program, table_name):
    outs = []
    for op in program.global_block().ops:
        if op.type == LOOKUP_TABLE_TYPE and \
                table_name == op.input("W")[0]:
            outs.extend(op.output("Out"))
    return outs
