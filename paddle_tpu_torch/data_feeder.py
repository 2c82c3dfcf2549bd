"""DataFeeder: host-side batch assembly.

Counterpart of paddle_tpu/data_feeder.py (parity:
python/paddle/fluid/data_feeder.py). Converts a minibatch (a list of
example tuples) into the Executor's feed dict of numpy arrays; the
Executor moves them to its device. Sequence slots (lod_level > 0) become
SequenceTensors padded to the JAX package's length buckets
(``lod.bucket_length``), so both packages feed the same arrays.
"""
import numpy as np

from .framework import Variable, default_main_program
from .lod import SequenceTensor, bucket_length

__all__ = ['DataFeeder']


class DataToLoDTensorConverter(object):
    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = [s for s in shape]
        self.dtype = dtype
        self.data = []

    def feed(self, data):
        self.data.append(data)

    def done(self):
        if self.lod_level == 0:
            arr = np.asarray(self.data, dtype=self.dtype)
            shape = [s for s in self.shape if s != -1]
            if shape and list(arr.shape[1:]) != shape and \
                    int(np.prod(arr.shape[1:])) == int(np.prod(shape)):
                arr = arr.reshape([arr.shape[0]] + shape)
            elif arr.ndim == 1 and shape == [1]:
                arr = arr[:, None]
            return arr
        if self.lod_level == 1:
            seqs = [np.asarray(s, dtype=self.dtype) for s in self.data]
            lens = np.asarray([len(s) for s in seqs], np.int32)
            max_len = bucket_length(int(lens.max()) if len(lens) else 1)
            feat = list(seqs[0].shape[1:]) if seqs[0].ndim > 1 else []
            trailing = [s for s in self.shape if s != -1]
            if not feat and trailing == [1]:
                feat = [1]
                seqs = [s[:, None] if s.ndim == 1 else s for s in seqs]
            out = np.zeros([len(seqs), max_len] + feat, dtype=self.dtype)
            for i, s in enumerate(seqs):
                out[i, :len(s)] = s
            return SequenceTensor(out, lens)
        # lod_level == 2: list of list of sequences
        from .lod import create_lod_tensor
        outer = [len(ex) for ex in self.data]
        inner = [len(s) for ex in self.data for s in ex]
        flat = [item for ex in self.data for s in ex for item in s]
        arr = np.asarray(flat, dtype=self.dtype)
        if arr.ndim == 1:
            arr = arr[:, None]
        return create_lod_tensor(arr, [outer, inner], self.place)


class DataFeeder(object):
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("Feed list should contain a list of "
                                "variable")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    @staticmethod
    def _shape_dense(arr, shape):
        """The lod-0 reshape contract of DataToLoDTensorConverter.done,
        shared verbatim by the fast path so both produce identical
        arrays."""
        trailing = [s for s in shape if s != -1]
        if trailing and list(arr.shape[1:]) != trailing and \
                int(np.prod(arr.shape[1:])) == int(np.prod(trailing)):
            arr = arr.reshape([arr.shape[0]] + trailing)
        elif arr.ndim == 1 and trailing == [1]:
            arr = arr[:, None]
        return arr

    def _feed_dense_fast(self, iterable):
        """Fast path for already-batched dense inputs: one
        ``np.asarray`` + reshape per slot instead of per-row converter
        dispatch. Returns None whenever the input does not provably fit
        (any LoD slot, ragged rows, field-count mismatch) — the slow
        path then reproduces the classic behavior, including its error
        messages."""
        if any(l != 0 for l in self.feed_lod_level):
            return None
        n_slots = len(self.feed_names)
        if isinstance(iterable, np.ndarray):
            # a single pre-batched dense array feeds a 1-slot list with
            # zero per-row work
            if n_slots != 1 or iterable.dtype == object or \
                    iterable.ndim == 0:
                return None
            arr = np.asarray(iterable, dtype=self.feed_dtypes[0])
            return {self.feed_names[0]: self._shape_dense(
                arr, self.feed_shapes[0])}
        if not isinstance(iterable, (list, tuple)) or not iterable:
            return None
        first = iterable[0]
        if not isinstance(first, (list, tuple, np.ndarray)) or \
                len(first) != n_slots:
            return None
        try:
            if any(len(s) != n_slots for s in iterable):
                return None   # slow path raises the classic assert
        except TypeError:
            return None
        out = {}
        try:
            for i, (name, shape, dtype) in enumerate(zip(
                    self.feed_names, self.feed_shapes,
                    self.feed_dtypes)):
                col = [sample[i] for sample in iterable]
                arr = np.asarray(col, dtype=dtype)
                if arr.dtype == object:
                    return None          # ragged rows: not dense
                out[name] = self._shape_dense(arr, shape)
        except (ValueError, TypeError, IndexError, KeyError):
            return None   # let the slow path produce the classic error
        return out

    def feed(self, iterable, _force_slow=False):
        if not _force_slow:
            fast = self._feed_dense_fast(iterable)
            if fast is not None:
                return fast
        converters = []
        for lod_level, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes):
            converters.append(DataToLoDTensorConverter(
                place=self.place, lod_level=lod_level, shape=shape,
                dtype=dtype))
        for each_sample in iterable:
            assert len(each_sample) == len(converters), (
                "The number of fields in data (%s) does not match "
                "len(feed_list) (%s)" % (len(each_sample), len(converters)))
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        ret_dict = {}
        for each_name, each_converter in zip(self.feed_names, converters):
            ret_dict[each_name] = each_converter.done()
        return ret_dict

    def decorate_reader(self, reader, multi_devices=False,
                        num_places=None, drop_last=True):
        """Wrap a batch reader so it yields ready feed dicts. Parity:
        data_feeder.py::DataFeeder.decorate_reader. ``multi_devices``
        feeds a data-parallel executor, which the port does not have
        yet (ROADMAP Queue A, item 6)."""
        if multi_devices:
            raise NotImplementedError(
                "DataFeeder.decorate_reader(multi_devices=True) needs data "
                "parallelism, which paddle_tpu_torch does not have yet "
                "(ROADMAP Queue A, item 6)")

        def __reader_creator__():
            for item in reader():
                yield self.feed(item)
        return __reader_creator__
