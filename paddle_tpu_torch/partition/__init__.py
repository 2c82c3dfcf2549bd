"""paddle_tpu_torch.partition: the partition layer's mesh-free rules.

Counterpart of paddle_tpu/partition/: ``rules.py`` copied whole (the
logical-axis rules and ``resolve_entry``) and ``first_divisible_dim``
from ``partitioner.py``, the one divisibility rule the ZeRO gradient
slicing and the partitioner's degradation share. The static verifier's
sharding check (``analysis.check_sharding``) evaluates them with no
mesh. The ``Partitioner`` itself waits for data parallelism on
``torch.distributed`` (ROADMAP Queue A item 6).
"""
from .rules import AxisNames, standard_logical_axis_rules, resolve_entry

__all__ = ['first_divisible_dim', 'AxisNames',
           'standard_logical_axis_rules', 'resolve_entry']


def first_divisible_dim(shape, extent):
    """Index of the first dim an ``extent``-way shard divides evenly,
    or None. The ONE divisibility rule shared by the ZeRO transpiler's
    accumulator slicing and the partitioner's degradation: both must
    agree or a transpile-time annotation could silently degrade at
    partition time."""
    for d, e in enumerate(shape):
        if extent and int(e) % extent == 0 and int(e) >= extent:
            return d
    return None
