"""Minimal graphviz dot writer (no external binary needed).

Counterpart of paddle_tpu/graphviz.py (parity:
python/paddle/fluid/graphviz.py): the same Graph/Node/Edge surface;
``Graph.show``/``save`` write the .dot text (rendering to an image needs
a dot binary, so the source is what is saved).
"""

__all__ = ['Graph', 'Node', 'Edge', 'GraphPreviewGenerator']


def crepr(v):
    if isinstance(v, str):
        return '"%s"' % v
    return str(v)


class Rank(object):
    def __init__(self, kind, name, priority):
        self.kind = kind
        self.name = name
        self.priority = priority
        self.nodes = []


class Node(object):
    counter = 1

    def __init__(self, label, prefix, description="", **attrs):
        self.label = label
        self.name = "%s_%d" % (prefix, Node.counter)
        Node.counter += 1
        self.attrs = attrs
        self.attrs['label'] = label

    def __str__(self):
        attrs = ','.join('%s=%s' % (k, crepr(v))
                         for k, v in sorted(self.attrs.items()))
        return "%s [%s]" % (self.name, attrs)


class Edge(object):
    def __init__(self, source, target, **attrs):
        self.source = source
        self.target = target
        self.attrs = attrs

    def __str__(self):
        attrs = ','.join('%s=%s' % (k, crepr(v))
                         for k, v in sorted(self.attrs.items()))
        return "%s -> %s [%s]" % (self.source.name, self.target.name,
                                  attrs)


class Graph(object):
    rank_counter = 0

    def __init__(self, title, **attrs):
        self.title = title
        self.attrs = attrs
        self.nodes = []
        self.edges = []
        self.rank_groups = {}

    def code(self):
        lines = ["digraph G {"]
        for k, v in sorted(self.attrs.items()):
            lines.append("  %s=%s;" % (k, crepr(v)))
        for n in self.nodes:
            lines.append("  " + str(n))
        for e in self.edges:
            lines.append("  " + str(e))
        lines.append("}")
        return "\n".join(lines)

    def node(self, label, prefix="node", description="", **attrs):
        n = Node(label, prefix, description, **attrs)
        self.nodes.append(n)
        return n

    def edge(self, source, target, **attrs):
        e = Edge(source, target, **attrs)
        self.edges.append(e)
        return e

    def save(self, path):
        with open(path, 'w') as f:
            f.write(self.code())
        return path

    # parity alias: reference pipes through `dot`; we persist the source
    show = save

    def __str__(self):
        return self.code()


class GraphPreviewGenerator(object):
    """Parity: graphviz.py::GraphPreviewGenerator (data-flow previews)."""

    def __init__(self, title):
        self.graph = Graph(title, layout="dot")

    def add_param(self, name, data_type, highlight=False):
        return self.graph.node(
            "%s\n%s" % (name, data_type), prefix="param",
            shape="box", style="filled",
            fillcolor="yellow" if highlight else "lightgrey")

    def add_op(self, opType, **kwargs):
        # plain label: crepr() double-quotes, so HTML-like <...> markup
        # would render literally
        return self.graph.node(opType, prefix="op", shape="ellipse")

    def add_arg(self, name, highlight=False):
        return self.graph.node(name, prefix="arg", shape="box",
                               style="rounded")

    def add_edge(self, source, target, **kwargs):
        return self.graph.edge(source, target, **kwargs)
