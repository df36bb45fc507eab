"""Program visualization and debugging helpers (counterpart of
paddle_tpu/debugger.py).

Reference parity: python/paddle/fluid/debugger.py (pprint_program +
graphviz drawing via net_drawer.py). The op graph is rendered straight
from the Program IR (no proto) as DOT text: no graphviz binary is
needed to make it.
"""

__all__ = ["pprint_program", "draw_program", "draw_block_graphviz"]


def pprint_program(program, print_fn=print):
    """Pretty-print a Program (reference pprint_program)."""
    print_fn(str(program))


def _quote(s):
    return '"%s"' % str(s).replace('"', '\\"')


def draw_block_graphviz(block, highlights=None, path=None):
    """Render one block's op/var graph as graphviz DOT text (reference
    debugger.draw_block_graphviz). Ops are boxes, variables are ellipses,
    edges follow input/output slots. Writes to `path` if given; always
    returns the DOT text. No graphviz runtime needed — the text renders
    with any `dot` binary or web viewer."""
    highlights = set(highlights or ())
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars = {}

    def var_node(name):
        if name not in seen_vars:
            vid = "var_%d" % len(seen_vars)
            seen_vars[name] = vid
            var = block._find_var_recursive(name)
            label = name
            if var is not None and var.shape is not None:
                label = "%s\\n%s %s" % (name, var.dtype,
                                        tuple(var.shape))
            style = "filled" if name in highlights else "solid"
            lines.append(
                '  %s [label=%s, shape=ellipse, style=%s, '
                'fillcolor=lightpink];' % (vid, _quote(label), style))
        return seen_vars[name]

    for i, op in enumerate(block.ops):
        oid = "op_%d" % i
        lines.append(
            '  %s [label=%s, shape=box, style=filled, '
            'fillcolor=lightblue];' % (oid, _quote(op.type)))
        for slot, names in sorted(op.inputs.items()):
            for name in names:
                lines.append('  %s -> %s [label=%s];'
                             % (var_node(name), oid, _quote(slot)))
        for slot, names in sorted(op.outputs.items()):
            for name in names:
                lines.append('  %s -> %s [label=%s];'
                             % (oid, var_node(name), _quote(slot)))
    lines.append("}")
    text = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def draw_program(program, path=None, block_idx=0, highlights=None):
    """DOT graph of `program`'s block `block_idx` (reference
    net_drawer.draw_graph / debugger entry point)."""
    return draw_block_graphviz(program.blocks[block_idx],
                               highlights=highlights, path=path)
