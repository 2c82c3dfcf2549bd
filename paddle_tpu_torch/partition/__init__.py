"""paddle_tpu_torch.partition: the partition layer.

Counterpart of paddle_tpu/partition/, its data-parallel half: ``rules.py``
copied whole (the logical-axis rules and ``resolve_entry``) and
``partitioner.py``'s :class:`Partitioner` over a ``torch.distributed``
dp group (``parallel.mesh.DPGroup``), with ``first_divisible_dim``, the
one divisibility rule the ZeRO gradient slicing and the partitioner's
degradation share. The static verifier's sharding check
(``analysis.check_sharding``) evaluates the rules with no group. Tensor
parallelism (an ``mp`` axis) is ROADMAP Queue A item 6.
"""
from .partitioner import (Partitioner, first_divisible_dim,  # noqa
                          mesh_axis_extent)
from .rules import AxisNames, standard_logical_axis_rules, resolve_entry

__all__ = ['Partitioner', 'first_divisible_dim', 'mesh_axis_extent',
           'AxisNames', 'standard_logical_axis_rules', 'resolve_entry']
