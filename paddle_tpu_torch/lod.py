"""SequenceTensor: a batch of variable-length sequences, padded or packed.

Counterpart of paddle_tpu/lod.py, copied and trimmed. The reference
packs sequences contiguously with a "level of detail" offset table; this
port, like the JAX package, stores a batch of sequences as

    data    : [batch, padded_len, *feature_dims]   (dense)
    lengths : [batch]                               (true lengths)

and masks where the semantics require it. ``padded_len`` is rounded up
to a bucket (``bucket_length``), the same buckets as the JAX package, so
both run a recurrent scan over the same number of steps. Nested LoD
(level 2, e.g. paragraphs of sentences) adds ``sub_lengths`` [batch,
padded_outer], the inner lengths.

``data``, ``lengths`` and ``sub_lengths`` are numpy arrays as
``create_lod_tensor`` makes them, and torch tensors on the Executor's
device once fed (``lengths`` as int64 there). The op kernels read
lengths from the device, so no step waits on the host.

The packed mode (``from_packed``) keeps the reference's own layout:
``data`` is the packed rows [sum_rows, *feat] (a tensor on the
Executor's device once fed), ``lengths`` is None and the offset LoD is a
list of host lists (``offsets()``). The dynamic beam decode runs in it:
a While whose beam search is fed 2-level LoD (``init_ids`` /
``init_scores``, set with ``set`` and ``set_lod``), where the number of
rows changes from step to step. Everything else stays padded.
"""
import numpy as np

__all__ = ['SequenceTensor', 'create_lod_tensor',
           'create_random_int_lodtensor', 'bucket_length']

_BUCKETS = (8, 16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
            1536, 2048, 3072, 4096, 8192)


def bucket_length(n):
    """Round ``n`` up to the next bucket (the JAX package's, so both pad
    alike)."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / 1024.0) * 1024)


def _host(a):
    """A numpy view of a numpy array or a (possibly device) tensor."""
    if hasattr(a, 'detach'):
        a = a.detach().cpu()
        if a.dtype.is_floating_point and a.element_size() < 4:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


class SequenceTensor(object):
    """Dense padded sequences + lengths.

    Also constructible the reference's imperative way
    (``t = LoDTensor(); t.set(rows, place); t.set_lod([offsets])``): the
    packed rows and offset LoD are converted to the padded layout. With
    ``set`` but no ``set_lod`` the tensor is a plain dense array
    (``lengths`` is None), which the Executor feeds as such.
    """

    def __init__(self, data=None, lengths=None, sub_lengths=None):
        self.data = data
        self.lengths = lengths
        self.sub_lengths = sub_lengths
        self._rows = None
        self._offsets = None

    @classmethod
    def from_packed(cls, rows, offsets):
        """Packed-mode tensor: the reference layout, rows [sum_rows,
        *feat] and the offset LoD as host lists, with no padded copy.
        The dynamic beam decode's values, whose row counts change from
        step to step."""
        st = cls()
        st.data = rows
        st._rows = rows
        st._offsets = [[int(o) for o in level] for level in offsets]
        return st

    @property
    def packed_mode(self):
        return self.lengths is None and self._offsets is not None

    def offsets(self):
        """The absolute offset LoD: kept as it is in packed mode,
        computed from the lengths otherwise."""
        if self._offsets is not None:
            return [list(level) for level in self._offsets]
        return self.lod()

    def set(self, array, place=None):
        """Reference LoDTensor.set(np_array, place): packed rows."""
        self._rows = np.asarray(array)
        self._rebuild()

    def set_lod(self, lod):
        """Reference LoDTensor.set_lod(offset_lod): per-level offsets."""
        self._offsets = [list(level) for level in lod]
        self._rebuild()

    def _rebuild(self):
        if self._rows is None:
            return
        if not self._offsets:
            self.data, self.lengths, self.sub_lengths = self._rows, None, None
            return
        lens = [[off[i + 1] - off[i] for i in range(len(off) - 1)]
                for off in self._offsets]
        # offset-form LoD may under-cover the rows (rows past the last
        # offset are unused): trim before the strict lengths form
        covered = int(self._offsets[-1][-1])
        built = create_lod_tensor(self._rows[:covered], lens)
        self.data = built.data
        self.lengths = built.lengths
        self.sub_lengths = built.sub_lengths

    def __array__(self, dtype=None, copy=None):
        """np.array(t) recovers the reference's packed-rows layout."""
        arr = _host(self.data) if self.lengths is None \
            else self.to_dense_rows()
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def lod_level(self):
        if self.packed_mode:
            return len(self._offsets)
        return 2 if self.sub_lengths is not None else 1

    def _inner_lengths(self):
        """Flattened level-2 inner lengths in LoD order (one entry per
        real sub-sequence)."""
        lens = _host(self.lengths).astype(int)
        sub = _host(self.sub_lengths)
        return [int(sub[i, j]) for i in range(len(lens))
                for j in range(int(lens[i]))]

    def recursive_sequence_lengths(self):
        if self.lengths is None:
            return [[b - a for a, b in zip(level[:-1], level[1:])]
                    for level in (self._offsets or [])]
        lens = _host(self.lengths).tolist()
        if self.sub_lengths is None:
            return [lens]
        return [lens, self._inner_lengths()]

    def lod(self):
        """Reference-style offset LoD."""
        if self.lengths is None:
            return [list(level) for level in (self._offsets or [])]
        out = [np.concatenate([[0], np.cumsum(_host(self.lengths))])
               .astype(int).tolist()]
        if self.sub_lengths is not None:
            out.append(np.concatenate(
                [[0], np.cumsum(self._inner_lengths())]).astype(int)
                .tolist())
        return out

    def to_dense_rows(self):
        """Back to the reference's packed [sum(lengths), ...] layout, on
        the host."""
        data = _host(self.data)
        if self.lengths is None:
            return data
        lens = _host(self.lengths).astype(int)
        if self.sub_lengths is not None:
            sub = _host(self.sub_lengths).astype(int)
            return np.concatenate(
                [data[i, j, :sub[i, j]] for i in range(len(lens))
                 for j in range(int(lens[i]))], axis=0)
        return np.concatenate([data[i, :int(lens[i])]
                               for i in range(len(lens))], axis=0)

    def __repr__(self):
        if self.packed_mode:
            return "SequenceTensor(packed rows=%s %s, lod=%s)" % (
                tuple(self.data.shape), self.data.dtype, self._offsets)
        return "SequenceTensor(data=%s %s, lengths=%s)" % (
            tuple(self.data.shape), self.data.dtype,
            None if self.lengths is None else tuple(self.lengths.shape))


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Build a SequenceTensor from packed data + recursive sequence lengths.

    Parity: fluid.create_lod_tensor(data, recursive_seq_lens, place).
    ``data``: np.ndarray of shape [sum(lens), *feat] or a list of
    sequences. The result holds numpy arrays; the Executor moves it to
    its device when it is fed.
    """
    if isinstance(data, list):
        seq_lens = [len(s) for s in data]
        if recursive_seq_lens is None:
            recursive_seq_lens = [seq_lens]
        flat = []
        for s in data:
            flat.extend(s)
        arr = np.asarray(flat)
        if arr.ndim == 1:
            arr = arr[:, None]
        data = arr
    data = np.asarray(data)
    lens = list(recursive_seq_lens[-1])
    # the last level's lengths must tile the data rows exactly, and each
    # outer level must group all of the next level's sequences
    if int(np.sum(lens)) != int(data.shape[0]):
        raise ValueError(
            "recursive_seq_lens %r sums to %d but data has %d rows"
            % (recursive_seq_lens, int(np.sum(lens)), int(data.shape[0])))
    for outer_l, inner_l in zip(recursive_seq_lens, recursive_seq_lens[1:]):
        if int(np.sum(outer_l)) != len(inner_l):
            raise ValueError(
                "lod level %r groups %d sequences but the next level "
                "has %d" % (list(outer_l), int(np.sum(outer_l)),
                            len(inner_l)))
    if len(recursive_seq_lens) > 1:
        # level 2: the outer lengths group the inner sequences
        outer = list(recursive_seq_lens[0])
        inner = lens
        max_outer = bucket_length(max(outer)) if outer else 1
        max_inner = bucket_length(max(inner)) if inner else 1
        feat = data.shape[1:]
        out = np.zeros((len(outer), max_outer, max_inner) + feat, data.dtype)
        sub = np.zeros((len(outer), max_outer), np.int32)
        pos = k = 0
        for i, n_inner in enumerate(outer):
            for j in range(n_inner):
                L = inner[k]
                out[i, j, :L] = data[pos:pos + L]
                sub[i, j] = L
                pos += L
                k += 1
        return SequenceTensor(out, np.asarray(outer, np.int32), sub)
    max_len = bucket_length(max(lens)) if lens else 1
    feat = data.shape[1:]
    out = np.zeros((len(lens), max_len) + feat, data.dtype)
    pos = 0
    for i, L in enumerate(lens):
        out[i, :L] = data[pos:pos + L]
        pos += L
    return SequenceTensor(out, np.asarray(lens, np.int32))


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    lens = recursive_seq_lens[-1]
    shape = [int(np.sum(lens))] + list(base_shape)
    data = np.random.randint(low, high + 1, size=shape).astype('int64')
    return create_lod_tensor(data, recursive_seq_lens, place)
