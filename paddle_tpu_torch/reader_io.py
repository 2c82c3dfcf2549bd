"""RecordIO-backed program readers (host side).

Counterpart of paddle_tpu/reader_io.py (parity: paddle/fluid/recordio +
the reader ops, open_recordio_file etc.). The chunked PTRC format is
read natively by the C++ library (``native/recordio.cc``, built at first
use) with a Python fallback here; files are byte-compatible with the
JAX package's both ways. Records are pickles of plain numpy values
(lists of arrays, and ``('__seq__', data, lengths, sub_lengths)`` tuples
for sequence slots), so no pickle names a class of either package.
"""
import pickle
import struct
import zlib

import numpy as np

MAGIC = b'PTRC'


class RecordIOWriter(object):
    """Chunked record file: [MAGIC] then per record
    [u32 len][u32 crc32][payload]."""

    def __init__(self, path, compressor=None, max_num_records=1000):
        self.path = path
        self.f = open(path, 'wb')
        self.f.write(MAGIC)
        self.count = 0

    def write(self, record_bytes):
        payload = record_bytes
        self.f.write(struct.pack('<II', len(payload),
                                 zlib.crc32(payload) & 0xffffffff))
        self.f.write(payload)
        self.count += 1

    def write_arrays(self, arrays):
        self.write(pickle.dumps([np.asarray(a) for a in arrays],
                                protocol=4))

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_records(path):
    with open(path, 'rb') as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise IOError("%s is not a paddle_tpu recordio file" % path)
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            length, crc = struct.unpack('<II', header)
            payload = f.read(length)
            if (zlib.crc32(payload) & 0xffffffff) != crc:
                raise IOError("recordio crc mismatch in %s" % path)
            yield payload


def _rebuild_slots(slots):
    """PTRC records tag LoD-carrying slots as
    ('__seq__', data, lengths, sub_lengths): rebuild the SequenceTensor
    so sequence ops downstream of read_file see the lengths (plain
    arrays pass through; old files with untagged slots still read)."""
    from .lod import SequenceTensor
    out = []
    for s in slots:
        if isinstance(s, tuple) and len(s) == 4 and s[0] == '__seq__':
            out.append(SequenceTensor(s[1], s[2], s[3]))
        else:
            out.append(s)
    return type(slots)(out) if isinstance(slots, tuple) else out


class RecordIOSource(object):
    """Host-side source bound to open_recordio_file/open_files outputs."""

    def __init__(self, filenames, shapes, dtypes, lod_levels, pass_num=1):
        if isinstance(filenames, str):
            filenames = [filenames]
        self.filenames = filenames
        self.shapes = shapes
        self.dtypes = dtypes
        self.lod_levels = lod_levels
        self.pass_num = pass_num

    def _iter_reference(self, fn):
        """Reference-layout recordio file (recordio_compat): fluid
        LoDTensor-bundle records become tuples (SequenceTensor for
        lod-carrying entries); legacy v2 records are pickled samples."""
        from . import recordio_compat as rc
        from .lod import create_lod_tensor
        for rec in rc.read_reference_records(fn):
            try:
                items = rc.unpack_lod_tensor_record(rec)
            except Exception:
                yield pickle.loads(rec)
                continue
            sample = []
            for arr, lod in items:
                if lod and len(lod[0]) > 1:
                    lens = [[int(b - a) for a, b in zip(l[:-1], l[1:])]
                            for l in lod]
                    sample.append(create_lod_tensor(arr, lens))
                else:
                    sample.append(arr)
            yield tuple(sample)

    def __iter__(self):
        from .native import loader as native_loader
        from . import recordio_compat as rc
        for _ in range(self.pass_num):
            for fn in self.filenames:
                if rc.is_reference_recordio(fn):
                    for sample in self._iter_reference(fn):
                        yield sample
                    continue
                if native_loader.available():
                    it = native_loader.read_records(fn)
                else:
                    native_loader.READS['python'] += 1
                    it = read_records(fn)
                for payload in it:
                    yield _rebuild_slots(pickle.loads(payload))


class RandomDataSource(object):
    """Parity: layers/io.py::random_data_generator (reference
    create_random_data_generator op): a dummy reader producing float32
    uniform samples of the declared shapes, for testing networks without
    real files. Its draws equal the JAX package's for one seed."""

    def __init__(self, low, high, shapes, lod_levels, seed=0,
                 n_samples=None):
        self.low = float(low)
        self.high = float(high)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.lod_levels = lod_levels
        self.seed = seed
        self.n_samples = n_samples    # None = endless, like the ref op

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        i = 0
        while self.n_samples is None or i < self.n_samples:
            yield tuple(rng.uniform(self.low, self.high, s)
                        .astype('float32') for s in self.shapes)
            i += 1


def _stack(samples):
    return tuple(np.stack([s[i] for s in samples])
                 for i in range(len(samples[0])))


def iterate_reader(reader_var):
    """The host-side batch iterator of a program reader: the bound source
    run through its decorator chain (parity: the reference's
    decorated-reader op stack, layers/io.py:545-570)."""
    def src():
        return iter(reader_var.source)

    it_fn = src
    for kind, arg in reader_var.decorators:
        prev = it_fn
        if kind == 'multi_pass':
            def it_fn(prev=prev, n=arg):
                for _ in range(int(n)):
                    for item in prev():
                        yield item
        elif kind == 'shuffle':
            # the reader decorator's shuffle: the same stream of items
            from .reader import shuffle as _shuffle

            def it_fn(prev=prev, buf=arg):
                return _shuffle(prev, buf)()
        elif kind == 'batch':
            # NOT reader.batch: program readers STACK samples into batch
            # arrays (the read op's tensor contract), and the trailing
            # PARTIAL batch is yielded, not dropped (ref
            # create_batch_reader_op.cc)
            def it_fn(prev=prev, bs=arg):
                cur = []
                for item in prev():
                    cur.append(item)
                    if len(cur) == bs:
                        yield _stack(cur)
                        cur = []
                if cur:
                    yield _stack(cur)
        elif kind in ('parallel', 'double_buffer'):
            # threaded prefetch (ref create_threaded_reader /
            # create_double_buffer_reader) through PrefetchPipeline: a
            # daemon thread pulls ahead into a bounded queue, order kept,
            # errors propagate. double_buffer(place=...) stages each batch
            # on that device ON THE WORKER (pinned buffer, side stream,
            # event), so the copy to the card overlaps the step and the
            # Executor takes the tensor as it is
            def it_fn(prev=prev, depth=4 if kind == 'parallel' else 2,
                      place=arg if kind == 'double_buffer' else None):
                from .reader.prefetch import PrefetchPipeline
                return iter(PrefetchPipeline(prev, depth=depth,
                                             place=place))
        else:  # pragma: no cover - unknown decorators pass through
            it_fn = prev
    return it_fn()
