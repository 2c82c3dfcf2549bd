"""The data-parallel group: the port's counterpart of the device mesh.

Counterpart of paddle_tpu/parallel/mesh.py. The JAX package's mesh is a
``jax.sharding.Mesh`` whose ``dp`` axis XLA's SPMD partitioner shards
one program over. Here data parallelism is one process per rank over an
initialised ``torch.distributed`` process group, and the mesh is a
:class:`DPGroup`: its world size, this process's rank and this rank's
device. A single-process run is a group of one.

The rank-to-device rule is fixed: rank r runs on ``cuda:(r % n)`` where
the host has n cards, on the CPU where it has none. The backend follows
from that map (:func:`backend_for`): NCCL where every rank has a card of
its own, gloo where ranks share one (NCCL refuses two ranks of one
communicator on one device) or run on the CPU. ``init_dp`` creates the
process group with a ``timeout`` (default 60 s), so a rank whose
collectives fall out of step with the others raises instead of hanging.

Only the ``dp`` axis exists: a mesh shape naming ``mp``/``tp`` (tensor
parallelism) or another axis raises, naming ROADMAP Queue A item 6.
"""
import datetime

import torch

__all__ = ['DPGroup', 'get_mesh', 'set_mesh', 'clean_spec', 'init_dp',
           'shutdown_dp', 'device_for_rank', 'backend_for', 'dp_scope',
           'active_group']

_current_mesh = None

_MODEL_AXES_MSG = ('only data parallelism (the dp axis) is ported; '
                   'tensor, pipeline and sequence parallelism are ROADMAP '
                   'Queue A item 6')


class DPGroup(object):
    """One rank's view of the data-parallel group: ``size`` ranks, this
    process's ``rank``, its ``device`` and the process group's
    ``backend`` (None for a group of one, which needs none)."""

    axis_names = ('dp',)

    def __init__(self, size=1, rank=0, device=None, backend=None,
                 pg=None):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device) if device is not None else \
            torch.device('cpu')
        self.backend = backend
        self.pg = pg

    @property
    def shape(self):
        return (self.size,)

    def token(self):
        """Hashable identity: axis, extent, rank, device and backend. Two
        groups that differ in any of these never share a lowered
        program."""
        return (self.axis_names, self.shape, self.rank, str(self.device),
                self.backend)

    def __repr__(self):
        return 'DPGroup(dp=%d, rank=%d, device=%s, backend=%s)' % (
            self.size, self.rank, self.device, self.backend)


def clean_spec(spec, mesh, ndim=None):
    """Sanitize a Variable.sharding tuple against a mesh: axis names not
    in the mesh degrade to None (replicated on that dim); optionally
    truncate to ndim. Same contract as the JAX package's."""
    axes = set(mesh.axis_names)

    def clean(entry):
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axes)
            return kept or None
        return entry if entry in axes else None

    out = [clean(e) for e in spec]
    if ndim is not None:
        out = out[:ndim]
    return out


def set_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def device_for_rank(rank, device_count=None):
    """Rank r's device: ``cuda:(r % n)`` with n cards, the CPU with
    none."""
    n = torch.cuda.device_count() if device_count is None else device_count
    if n <= 0:
        return torch.device('cpu')
    return torch.device('cuda', int(rank) % n)


def backend_for(world_size, device_count=None):
    """The backend the rank-to-device map calls for: ``nccl`` where every
    rank has a card of its own, ``gloo`` where ranks share a card or
    there is none."""
    n = torch.cuda.device_count() if device_count is None else device_count
    return 'nccl' if n > 0 and n >= int(world_size) else 'gloo'


def init_dp(rank, world_size, init_method, timeout=60.0, device_count=None):
    """Create the process group of ``world_size`` ranks (``init_method``:
    a ``file://`` or ``tcp://`` store) with the backend and device of
    the fixed map, make this rank's card current, and install the group
    as the mesh. Returns the :class:`DPGroup`."""
    import torch.distributed as dist
    n = torch.cuda.device_count() if device_count is None else device_count
    device = device_for_rank(rank, n)
    backend = backend_for(world_size, n)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=int(rank),
        world_size=int(world_size),
        timeout=datetime.timedelta(seconds=float(timeout)))
    return set_mesh(DPGroup(world_size, rank, device, backend,
                            dist.group.WORLD))


def shutdown_dp():
    """Destroy the process group and drop the mesh."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    set_mesh(None)


def get_mesh(num_devices=None, axes=None, shape=None):
    """The current group, else one read from the initialised
    ``torch.distributed`` process group, else a group of one.

    ``num_devices`` must equal the group's size (the port cannot carve a
    group out of the processes); ``shape`` may name only ``dp``."""
    global _current_mesh
    if shape:
        bad = [a for a in shape if a != 'dp']
        if bad:
            raise NotImplementedError('mesh axes %s: %s' % (bad,
                                                            _MODEL_AXES_MSG))
        num_devices = int(shape['dp'])
    if axes and tuple(axes) != ('dp',):
        raise NotImplementedError('mesh axes %s: %s' % (tuple(axes),
                                                        _MODEL_AXES_MSG))
    mesh = _current_mesh
    if mesh is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
            mesh = DPGroup(world, rank, device_for_rank(rank),
                           dist.get_backend(), dist.group.WORLD)
        else:
            mesh = DPGroup(1, 0, device_for_rank(0))
        _current_mesh = mesh
    if num_devices is not None and int(num_devices) != mesh.size:
        if int(num_devices) == 1:
            return DPGroup(1, 0, mesh.device)
        raise ValueError(
            'a dp group of %d ranks was asked for, but %d process(es) '
            'run: start one process per rank (parallel.mesh.init_dp)'
            % (num_devices, mesh.size))
    return mesh


# the group whose collectives a run may issue: bound by the executor of a
# dp partitioner for the length of its run (the counterpart of JAX's
# axis binding under shard_map); unbound, the collective ops are the
# identity
_ACTIVE = [None]


def active_group():
    """The group bound by a running dp program, or None."""
    g = _ACTIVE[0]
    return g if g is not None and g.size > 1 else None


class dp_scope(object):
    """Bind ``group`` for the collective ops while a program runs."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        self.prev = _ACTIVE[0]
        _ACTIVE[0] = self.group
        return self.group

    def __exit__(self, *exc):
        _ACTIVE[0] = self.prev
        return False
