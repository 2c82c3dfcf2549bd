"""Program inspection: a pseudo-code pretty printer and graphviz export.

Counterpart of paddle_tpu/debugger.py (parity:
python/paddle/fluid/debuger.py: pprint_program_codes, pprint_block_codes,
draw_block_graphviz) over the port's IR; the text is the JAX package's
for the same program.
"""
from . import framework
from .graphviz import GraphPreviewGenerator

__all__ = ['pprint_program_codes', 'pprint_block_codes',
           'draw_block_graphviz']

_HL_HEAD = '\033[33m'
_HL_TAIL = '\033[0m'


def _repr_var(var):
    lod = ', lod=%d' % var.lod_level if getattr(var, 'lod_level', 0) \
        else ''
    return "%s[%s%s]  # %s" % (
        var.name, 'x'.join(str(d) for d in (var.shape or ())), lod,
        var.dtype)


def _repr_attr(name, value):
    if isinstance(value, framework.Block):
        return "%s=block_%d" % (name, value.idx)
    if hasattr(value, 'idx') and hasattr(value, 'ops'):
        return "%s=block_%d" % (name, value.idx)
    r = repr(value)
    if len(r) > 40:
        r = r[:37] + '...'
    return "%s=%s" % (name, r)


def repr_op(op):
    outs = ", ".join(n for ns in op.outputs.values() for n in ns)
    ins = ", ".join("%s=[%s]" % (slot, ",".join(ns))
                    for slot, ns in sorted(op.inputs.items()))
    attrs = ", ".join(_repr_attr(k, v)
                      for k, v in sorted(op.attrs.items()))
    return "%s = %s(%s)%s" % (outs or '_', op.type, ins,
                              ('  # ' + attrs) if attrs else '')


def pprint_block_codes(block, show_backward=False, highlights=None):
    highlights = set(highlights or [])
    lines = ["# block %d (parent %d)" % (block.idx, block.parent_idx)]
    lines.append("# variables:")
    for name, var in sorted(block.vars.items()):
        mark = ' (persistable)' if getattr(var, 'persistable', False) \
            else ''
        lines.append("#   " + _repr_var(var) + mark)
    for op in block.ops:
        # our IR's backward is one marker op (not per-op *_grad descs)
        if not show_backward and (op.type.endswith('_grad') or
                                  op.type == 'backward_marker'):
            continue
        text = repr_op(op)
        if op.type in highlights or \
                any(n in highlights for ns in op.outputs.values()
                    for n in ns):
            text = _HL_HEAD + text + _HL_TAIL
        lines.append(text)
        sub = op.attrs.get('sub_block')
        if sub is not None:
            for sl in pprint_block_codes(sub, show_backward,
                                         highlights).splitlines():
                lines.append("    " + sl)
    return "\n".join(lines)


def pprint_program_codes(program, show_backward=False):
    return "\n\n".join(pprint_block_codes(b, show_backward)
                       for b in program.blocks)


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Write the block's dataflow graph as graphviz source."""
    highlights = set(highlights or [])
    g = GraphPreviewGenerator("program block %d" % block.idx)
    var_nodes = {}

    def var_node(name):
        if name not in var_nodes:
            var = block._find_var_recursive(name) \
                if hasattr(block, '_find_var_recursive') else None
            if var is not None and getattr(var, 'persistable', False):
                var_nodes[name] = g.add_param(
                    name, str(var.dtype), highlight=name in highlights)
            else:
                var_nodes[name] = g.add_arg(name,
                                            highlight=name in highlights)
        return var_nodes[name]

    for op in block.ops:
        op_node = g.add_op(op.type)
        for ns in op.inputs.values():
            for n in ns:
                g.add_edge(var_node(n), op_node)
        for ns in op.outputs.values():
            for n in ns:
                g.add_edge(op_node, var_node(n))
    g.graph.save(path)
    return path
