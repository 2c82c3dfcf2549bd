"""paddle_tpu_torch.kvcache: paged KV-cache and disaggregated prefill.

Counterpart of paddle_tpu/kvcache, with its names:

- :mod:`~paddle_tpu_torch.kvcache.pool`: :class:`PagePool`, a fixed
  pool of ``[page_size, ...]`` KV blocks behind a free-list allocator
  (typed :class:`PoolExhausted`), plus per-sequence :class:`BlockTable`\\ s.
  Admission becomes "allocate pages", so resident KV bytes track actual
  sequence lengths and sequences-resident decouples from the step
  program's batch dim.
- :mod:`~paddle_tpu_torch.kvcache.paged`: :func:`paged_attention_cell`,
  the slotted ``attention_history_cell`` re-expressed over pool pages
  (gather by block table + position mask), bit-identical outputs at the
  same slot count.
- :mod:`~paddle_tpu_torch.kvcache.prefill`: :class:`PrefillEngine`
  (prompt ingestion producing KV pages + carry state) and
  :class:`PrefillServer` (the replica-cell surface, so the fleet Router
  places prompt ingestion on dedicated ``role='prefill'`` replicas).
- :mod:`~paddle_tpu_torch.kvcache.disagg`: :class:`DisaggregatedDecoder`,
  which routes prompts to prefill replicas through the Router and
  streams the finished pages into a local paged
  :class:`~paddle_tpu_torch.fleet.decode.DecodeEngine`, one trace tree
  spanning the hop.
"""
from .pool import BlockTable, PagePool, PoolExhausted  # noqa
from .paged import paged_attention_cell  # noqa
from .prefill import (PrefillEngine, PrefillServer,  # noqa
                      build_cell, make_paged_engine, stock_spec)
from .disagg import DisaggregatedDecoder  # noqa

__all__ = [
    'PagePool', 'BlockTable', 'PoolExhausted',
    'paged_attention_cell',
    'PrefillEngine', 'PrefillServer', 'build_cell',
    'make_paged_engine', 'stock_spec',
    'DisaggregatedDecoder',
]
