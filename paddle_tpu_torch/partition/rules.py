"""Logical axis rules: how named tensor axes map onto mesh axes.

Counterpart of paddle_tpu/partition/rules.py, copied whole.

T5X-style indirection (SNIPPETS.md [1]-[3]): a ``Variable.sharding``
spec may name either a MESH axis directly (``'dp'``, ``'mp'``, ...) or
a LOGICAL axis (``'batch'``, ``'mlp'``, ``'vocab'``, ...). Logical
names are resolved through an ordered rule list at partition time, so
the same annotated program runs unchanged on a 1-device laptop mesh, a
dp-only pod slice, or a dp x mp x sp mesh — the rules (not the model
code) decide what actually shards where.

Resolution contract (shared with ``core.lowering``'s
``with_sharding_constraint`` pass via ``Partitioner.resolve_spec``):

- an entry naming a mesh axis passes through;
- an entry naming a logical axis becomes its ruled mesh axis (first
  rule wins), or ``None`` when the rule maps it nowhere / the mesh
  lacks the axis;
- anything unresolvable degrades to ``None`` (replicated on that dim)
  — annotations must never make a program unrunnable on a smaller
  mesh.
"""

__all__ = ['AxisNames', 'standard_logical_axis_rules', 'resolve_entry']


class AxisNames(tuple):
    """Tuple of per-dim axis names treated as a pytree LEAF, so JAX's
    tree utilities never descend into it (the T5X trick)."""

    def __new__(cls, *names):
        return super(AxisNames, cls).__new__(cls, names)

    def __repr__(self):
        return 'AxisNames%s' % (tuple(self),)


def standard_logical_axis_rules():
    """The default logical -> mesh axis rule list.

    Ordered pairs ``(logical_axis, mesh_axis_or_None)``; first match
    wins. Mesh axes follow parallel.mesh naming: dp = data, mp =
    tensor/model, pp = pipeline stage, sp = sequence.
    """
    return (
        ('batch', 'dp'),
        ('embed', None),       # d_model stays replicated (activations)
        ('heads', 'mp'),
        ('kv', None),
        ('mlp', 'mp'),
        ('vocab', 'mp'),
        ('seq', 'sp'),
        ('stage', 'pp'),
    )


def resolve_entry(entry, mesh_axes, rules):
    """One spec entry -> mesh axis name(s) or None.

    ``entry`` may be a mesh axis, a logical axis, a tuple of either, or
    None. ``rules`` is a dict or pair-sequence of logical -> mesh axis.
    """
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in (resolve_entry(e, mesh_axes, rules)
                                 for e in entry) if a is not None)
        return kept or None
    if entry in mesh_axes:
        return entry
    ruled = dict(rules).get(entry)
    return ruled if ruled in mesh_axes else None
