"""Draw a Program's op graph (debug visualization).

Counterpart of paddle_tpu/net_drawer.py (parity:
python/paddle/fluid/net_drawer.py): the same draw_graph surface over the
port's IR, emitting graphviz source through paddle_tpu_torch.graphviz.
"""
from .graphviz import Graph

__all__ = ['draw_graph']

OP_STYLE = dict(shape='oval', color='#0F9D58', style='filled',
                fontcolor='#FFFFFF')
VAR_STYLE = dict(shape='box')


def parse_graph(program, graph, var_dict, **kwargs):
    for block in program.blocks:
        for op in block.ops:
            op_node = graph.node("%s" % op.type, prefix="op", **OP_STYLE)
            for ns in op.inputs.values():
                for n in ns:
                    if n not in var_dict:
                        var_dict[n] = graph.node(n, prefix="var",
                                                 **VAR_STYLE)
                    graph.edge(var_dict[n], op_node)
            for ns in op.outputs.values():
                for n in ns:
                    if n not in var_dict:
                        var_dict[n] = graph.node(n, prefix="var",
                                                 **VAR_STYLE)
                    graph.edge(op_node, var_dict[n])


def draw_graph(startup_program, main_program, path="network.dot",
               **kwargs):
    graph = Graph(kwargs.get('graph_attr', {}).get('label', 'Network'))
    var_dict = {}
    parse_graph(startup_program, graph, var_dict)
    parse_graph(main_program, graph, var_dict)
    graph.save(path)
    return graph
