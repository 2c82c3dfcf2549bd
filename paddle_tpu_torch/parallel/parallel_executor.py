"""ParallelExecutor: data-parallel training and serving, one process per
rank.

Counterpart of paddle_tpu/parallel/parallel_executor.py (parity:
python/paddle/fluid/parallel_executor.py). The JAX package runs ONE
program over the global batch on a device mesh and lets XLA's SPMD
partitioner insert the collectives, so every value it computes equals a
single-device run at the global batch. Here each rank is a process
(``parallel.mesh.init_dp``) that runs the same program through the
port's ``Executor`` behind a dp :class:`~paddle_tpu_torch.partition.
Partitioner`, and the port makes the same promise explicitly:

- every rank is given the GLOBAL feed and keeps its rows of dim 0
  (``Partitioner.shard_feed``; a batch the group's size does not divide
  stays whole on every rank);
- the batch reductions are global (the loss's mean, batch-norm moments,
  ``accuracy``, ``reduce_*`` over dim 0), each rank's loss is seeded with
  its share, and the parameters' partial gradients are summed over the
  ranks (core/lowering.py, compiler/zero.py);
- fetches come back global: cut rows and ZeRO-sliced state all-gathered;
- parameters start equal: ``bcast_params`` broadcasts rank 0's
  persistables once, at construction (the ranks' startups are not
  trusted to agree);
- dropout draws from a generator of each rank's own, seeded by
  (program seed, rank).

ZeRO-2 is the default on a training ParallelExecutor over more than one
rank (``compiler.zero.apply_zero``); ``zero_stage=0`` keeps the
replicated path, whose results are bit-identical.
"""
import numpy as np
import torch

from ..core import places as _places
from ..core.lowering import RNG_KEY
from ..executor import Executor, global_scope, as_numpy
from ..framework import default_main_program
from ..partition import Partitioner

__all__ = ['ParallelExecutor', 'ExecutionStrategy', 'BuildStrategy']


class ExecutionStrategy(object):
    """Parity: core.ParallelExecutor.ExecutionStrategy. Scheduling knobs
    of the reference's threaded SSA-graph executor, carried as attributes
    for script compatibility; the executor reads none of them."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.use_event = True


class BuildStrategy(object):
    """Parity: core.ParallelExecutor.BuildStrategy, carried as
    attributes; the gradient aggregation is the port's own (a
    reduce-scatter and all-gather, or ZeRO-2)."""

    class ReduceStrategy(object):
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy(object):
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""


# the seed of rank r's dropout generator, from the program's seed
_RANK_SEED_STRIDE = 1000003


class ParallelExecutor(object):
    """Runs ``main_program`` data-parallel over the dp group. ``use_cuda``
    (the default) runs on this rank's card, ``cuda:(rank % cards)``, and
    raises on a host without CUDA; ``use_cuda=False`` runs on the CPU."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, num_threads=None,
                 allow_op_delay=False, use_tpu=True, num_devices=None,
                 mesh=None, partitioner=None, exec_strategy=None,
                 build_strategy=None, zero_stage=None,
                 zero_bucket_bytes=None):
        self._program = main_program or default_main_program()
        if partitioner is None:
            partitioner = Partitioner(mesh=mesh, num_devices=num_devices)
        self._partitioner = partitioner
        self._mesh = partitioner.mesh
        self._loss_name = loss_name
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._build_strategy = build_strategy or BuildStrategy()
        place = _places.CUDAPlace(partitioner.device.index or 0) \
            if use_cuda else _places.CPUPlace()
        self._exe = Executor(place, partitioner=partitioner)
        if share_vars_from is not None:
            # parity: share the scope of the training ParallelExecutor
            self._scope = share_vars_from._scope
        else:
            self._scope = global_scope()
        dp = partitioner.axis_extent('dp')
        if dp > 1 and share_vars_from is None:
            self.bcast_params()
            gen = torch.Generator(device=self._exe.device)
            gen.manual_seed((self._program.random_seed or 0) *
                            _RANK_SEED_STRIDE + partitioner.rank)
            self._scope.set_var(RNG_KEY, gen)
        # ZeRO-2 by default on a training ParallelExecutor over more
        # than one rank; zero_stage=0 keeps the replicated path
        self._zero = {'stage': 0, 'dp': 1}
        if loss_name is not None and dp > 1:
            from ..compiler import zero as _zero
            self._zero = _zero.apply_zero(
                self._program, dp, stage=zero_stage,
                bucket_bytes=zero_bucket_bytes)
        # each rank keeps only its slice of a sliced accumulator (again
        # before each run, for state a later startup or load writes whole)
        self._slice_state()

    @property
    def partitioner(self):
        return self._partitioner

    @property
    def device_count(self):
        return self._partitioner.device_count

    def cache_info(self):
        return self._exe.cache_info()

    def reset_cache_info(self):
        return self._exe.reset_cache_info()

    def _slice_state(self):
        if self._partitioner.active:
            from ..compiler import zero as _zero
            _zero.slice_state(self._scope, self._program, self._mesh)

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True, async_fetch=False):
        """One step over the GLOBAL ``feed``; fetches are global."""
        feed = feed if feed is not None else feed_dict or {}
        self._slice_state()
        return self._exe.run(program=self._program, feed=feed,
                             fetch_list=fetch_list or [],
                             scope=self._scope, return_numpy=return_numpy,
                             async_fetch=async_fetch)

    def run_chained(self, feed_list=None, fetch_list=None,
                    return_numpy=True, async_fetch=False, program=None):
        """K steps, one per feed of ``feed_list``, through
        ``Executor.run_chained`` (K runs in order); returns K fetch
        lists."""
        self._slice_state()
        return self._exe.run_chained(program or self._program,
                                     feed_list=feed_list,
                                     fetch_list=fetch_list,
                                     scope=self._scope,
                                     return_numpy=return_numpy,
                                     async_fetch=async_fetch)

    def _persistables(self):
        return list(dict.fromkeys(v.name for v in self._program.list_vars()
                                  if v.persistable))

    def bcast_params(self):
        """Parity: ParallelExecutor.bcast_params (the reference's NCCL
        broadcast). Every persistable tensor this rank's Scope holds for
        the program takes rank 0's value. Called once at construction."""
        if not self._partitioner.active:
            return 0
        from .collective import broadcast
        count = 0
        for name in self._persistables():
            val = self._scope.raw(name)
            if isinstance(val, np.ndarray):
                val = torch.from_numpy(np.ascontiguousarray(val))
            if not isinstance(val, torch.Tensor):
                continue
            dev = self._exe.device
            src = val.to(dev) if val.device != dev else val
            self._scope.holder(name).set_var(
                name, broadcast(src, root=0, group=self._mesh))
            count += 1
        return count

    def global_state(self, names=None):
        """{name: host array} of the program's persistables in the Scope,
        each whole: a ZeRO-sliced accumulator is all-gathered over the
        group (every rank must call this). A checkpoint's or a
        comparison's view of the state."""
        from ..compiler import zero as _zero
        from .collective import all_gather
        sliced = _zero.sliced_state_dims(self._program,
                                         self._partitioner.device_count)
        block = self._program.global_block()
        out = {}
        for name in (names or self._persistables()):
            val = self._scope.raw(name)
            if not isinstance(val, torch.Tensor):
                continue
            var = block._find_var_recursive(name)
            if name in sliced and var is not None and \
                    tuple(val.shape) != tuple(int(s) for s in var.shape):
                val = all_gather(val.contiguous(), axis=sliced[name],
                                 group=self._mesh)
            out[name] = np.asarray(as_numpy(val))
        return out

    def compile_stats(self, fetch_list=None, feed=None):
        """This rank's argument bytes (no execution): the bytes of the
        program's state in its Scope, which ZeRO cuts. Returns
        ``{'argument_bytes': n}``. The JAX package's ``temp_bytes`` and
        ``output_bytes`` read XLA's memory analysis, which the port has no
        counterpart of (ROADMAP Queue A item 6); ``fetch_list`` and
        ``feed`` are taken for its signature."""
        self._slice_state()
        total = 0
        for name in self._persistables():
            val = self._scope.raw(name)
            if isinstance(val, torch.Tensor):
                total += val.numel() * val.element_size()
        return {'argument_bytes': int(total)}
