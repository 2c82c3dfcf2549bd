"""The PTRC recordio format, the native reader, the reference's recordio
layout and the program readers' decorator chains: paddle_tpu_torch
against paddle_tpu, on the CPU.

Files are compared byte for byte (each package writes what the other
reads, and the same batches give the same bytes); batches element for
element, exactly. The cases of tests/test_io.py's program readers,
tests/test_native.py and tests/test_recordio_compat.py, each held
against paddle_tpu.
"""
import os
import pickle
import pickletools
import random

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
import paddle_tpu_torch as pt
from paddle_tpu import reader_io as j_rio
from paddle_tpu import recordio_compat as j_rc
from paddle_tpu import recordio_writer as j_rw
from paddle_tpu.native import loader as j_native
from paddle_tpu_torch import reader_io as t_rio
from paddle_tpu_torch import recordio_compat as t_rc
from paddle_tpu_torch import recordio_writer as t_rw
from paddle_tpu_torch.native import loader as t_native
# the reference's own .dat fixtures, where the JAX package's test finds them
from test_recordio_compat import REF_DIR


def _records(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return [pickle.dumps([rng.randn(4, 3).astype('float32'),
                          np.asarray([i], np.int64)], protocol=4)
            for i in range(n)]


def _write(writer_cls, path, payloads):
    with writer_cls(str(path)) as w:
        for p in payloads:
            w.write(p)


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    if hasattr(v, 'lengths') and v.lengths is not None:
        return (_host(v.data), _host(v.lengths),
                None if v.sub_lengths is None else _host(v.sub_lengths))
    return np.asarray(v)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            on_jax = type(b).__module__.startswith('jax')
            a, b = _host(a), _host(b)
            if on_jax and a.dtype == np.int64 and b.dtype == np.int32:
                # jax.device_put keeps int64 as int32 (x64 off): by value
                b = b.astype(np.int64)
            if isinstance(b, tuple):
                for x, y in zip(a, b):
                    assert (x is None) == (y is None)
                    if y is not None:
                        assert x.dtype == y.dtype
                        np.testing.assert_array_equal(x, y)
                continue
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ---- the native library --------------------------------------------------------
def test_native_builds_outside_the_package():
    assert t_native.available(), t_native.build_error()
    path = t_native.library_path()
    assert os.path.exists(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(pt.__file__)))
    assert os.path.dirname(path) == os.path.join(root, 'build', 'native')
    pkg_native = os.path.dirname(os.path.abspath(t_native.__file__))
    assert not [f for f in os.listdir(pkg_native) if f.endswith('.so')]


def test_native_reads_python_written_file(tmp_path):
    want = _records()
    _write(t_rio.RecordIOWriter, tmp_path / 'a.rio', want)
    assert list(t_native.read_records(str(tmp_path / 'a.rio'))) == want


def test_python_reads_native_written_file(tmp_path):
    payloads = [("record-%03d" % i).encode() * 7 for i in range(50)]
    assert t_native.write_records(str(tmp_path / 'n.rio'), payloads) == 50
    assert list(t_rio.read_records(str(tmp_path / 'n.rio'))) == payloads


def test_files_are_byte_compatible_with_paddle_tpu(tmp_path):
    """Each package's writers (Python and native) write the bytes the
    other's writers write, and each package's readers read the other's
    files."""
    payloads = _records(9, seed=3)
    paths = {}
    for name, write in (
            ('j_py', lambda p: _write(j_rio.RecordIOWriter, p, payloads)),
            ('t_py', lambda p: _write(t_rio.RecordIOWriter, p, payloads)),
            ('j_native', lambda p: j_native.write_records(str(p), payloads)),
            ('t_native', lambda p: t_native.write_records(str(p),
                                                          payloads))):
        if name == 'j_native' and not j_native.available():
            continue
        paths[name] = tmp_path / (name + '.rio')
        write(paths[name])
    blobs = {name: p.read_bytes() for name, p in paths.items()}
    assert len(set(blobs.values())) == 1, sorted(blobs)
    for p in paths.values():
        assert list(t_rio.read_records(str(p))) == payloads
        assert list(t_native.read_records(str(p))) == payloads
        assert list(j_rio.read_records(str(p))) == payloads


@pytest.mark.parametrize('reader', ['python', 'native'])
def test_crc_fault_raises(tmp_path, reader):
    p = tmp_path / 'bad.rio'
    _write(t_rio.RecordIOWriter, p, _records(3))
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF                    # flip a payload byte
    p.write_bytes(bytes(raw))
    read = t_rio.read_records if reader == 'python' else \
        t_native.read_records
    with pytest.raises(IOError, match='crc'):
        list(read(str(p)))
    with pytest.raises(IOError):
        list(j_rio.read_records(str(p)))


def test_not_a_recordio_file_raises(tmp_path):
    p = tmp_path / 'x.rio'
    p.write_bytes(b'JUNK' + b'\0' * 16)
    with pytest.raises(IOError, match='not a paddle_tpu recordio'):
        list(t_rio.read_records(str(p)))
    with pytest.raises(IOError, match='not a paddle_tpu recordio'):
        list(t_native.read_records(str(p)))


def test_prefetch_loader_multi_file_multi_pass(tmp_path):
    files, want = [], []
    for k in range(3):
        p = tmp_path / ('part-%d.rio' % k)
        recs = _records(10, seed=k)
        _write(t_rio.RecordIOWriter, p, recs)
        files.append(str(p))
        want += recs
    got = list(t_native.PrefetchLoader(files, n_threads=3, capacity=8,
                                       passes=2))
    # unordered across threads: compared as multisets
    assert sorted(got) == sorted(want * 2)


def test_prefetch_loader_raises_on_corrupt_or_missing_file(tmp_path):
    good = str(tmp_path / 'good.rio')
    t_native.write_records(good, [b'aaa', b'bbb'])
    bad = str(tmp_path / 'bad.rio')
    data = bytearray(open(good, 'rb').read())
    data[-2] ^= 0xFF
    open(bad, 'wb').write(bytes(data))
    with pytest.raises(IOError):
        list(t_native.PrefetchLoader([good, bad], n_threads=1))
    with pytest.raises(IOError):
        list(t_native.PrefetchLoader([good, str(tmp_path / 'missing.rio')],
                                     n_threads=1))


def test_recordio_source_reads_natively_and_falls_back(tmp_path,
                                                       monkeypatch):
    p = tmp_path / 'src.rio'
    _write(t_rio.RecordIOWriter, p, _records(5))
    before = dict(t_native.READS)
    rows = list(t_rio.RecordIOSource([str(p)], None, None, None))
    assert t_native.READS['native'] == before['native'] + 1
    assert len(rows) == 5 and rows[0][0].shape == (4, 3)
    monkeypatch.setattr(t_native, 'available', lambda: False)
    again = list(t_rio.RecordIOSource([str(p)], None, None, None))
    assert t_native.READS['python'] == before['python'] + 1
    _same_batches(again, rows)


# ---- the feeds written by both packages ------------------------------------------
def _feeder(pkg, with_seq):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name='x', shape=[6], dtype='float32')
        y = pkg.layers.data(name='y', shape=[1], dtype='int64')
        feeds = [x, y]
        if with_seq:
            feeds.append(pkg.layers.data(name='w', shape=[1], dtype='int64',
                                         lod_level=1))
    return pkg.DataFeeder(feed_list=feeds, place=pkg.CPUPlace(),
                          program=main)


def _sample_reader(n_batches=5, bs=3, with_seq=True, seed=0):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            batch = []
            for _ in range(bs):
                s = [rng.randn(6).astype('float32'),
                     int(rng.randint(0, 10))]
                if with_seq:
                    s.append([int(v) for v in rng.randint(
                        0, 50, rng.randint(1, 7))])
                batch.append(s)
            yield batch
    return reader


def _global_names(payload):
    return [arg for op, arg, _ in pickletools.genops(payload)
            if op.name in ('GLOBAL', 'STACK_GLOBAL', 'INST')
            and arg is not None] + [
        arg for op, arg, _ in pickletools.genops(payload)
        if op.name in ('SHORT_BINUNICODE', 'BINUNICODE', 'UNICODE')]


@pytest.mark.parametrize('with_seq', [False, True])
def test_converted_files_equal_paddle_tpu_and_name_no_package(tmp_path,
                                                              with_seq):
    """convert_reader_to_recordio_file by both packages on one reader:
    the same bytes; each record a pickle of plain numpy values, which
    names no class of either package; the sequences' lengths survive."""
    j_path, t_path = str(tmp_path / 'j.rio'), str(tmp_path / 't.rio')
    reader = _sample_reader(with_seq=with_seq)
    assert j_rw.convert_reader_to_recordio_file(
        j_path, reader, _feeder(fluid, with_seq)) == 5
    assert t_rw.convert_reader_to_recordio_file(
        t_path, reader, _feeder(pt, with_seq)) == 5
    assert open(j_path, 'rb').read() == open(t_path, 'rb').read()
    for payload in t_rio.read_records(t_path):
        names = ' '.join(str(n) for n in _global_names(payload))
        assert 'paddle' not in names and 'torch' not in names, names
    got = list(t_rio.RecordIOSource(t_path, None, None, None))
    want = list(j_rio.RecordIOSource(j_path, None, None, None))
    _same_batches(got, want)
    if with_seq:
        st = got[0][2]
        assert isinstance(st, pt.SequenceTensor)
        assert st.recursive_sequence_lengths() == \
            want[0][2].recursive_sequence_lengths()


def test_convert_reader_to_recordio_files_splits_like_paddle_tpu(tmp_path):
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    reader = _sample_reader(n_batches=7, with_seq=False)
    n_j = j_rw.convert_reader_to_recordio_files(
        str(tmp_path / 'j' / 'f.rio'), 3, reader, _feeder(fluid, False))
    n_t = t_rw.convert_reader_to_recordio_files(
        str(tmp_path / 't' / 'f.rio'), 3, reader, _feeder(pt, False))
    assert n_j == n_t == 6             # the trailing single batch is not
    names = sorted(os.listdir(str(tmp_path / 't')))
    assert names == sorted(os.listdir(str(tmp_path / 'j'))) == \
        ['f-00000.rio', 'f-00001.rio']
    for n in names:
        assert (tmp_path / 'j' / n).read_bytes() == \
            (tmp_path / 't' / n).read_bytes()


# ---- the sources and the decorator chains ---------------------------------------
def test_random_data_source_equals_paddle_tpu():
    args = (-1.0, 2.0, [(3, 4), (2,)], [0, 0])
    got = list(t_rio.RandomDataSource(*args, seed=7, n_samples=5))
    want = list(j_rio.RandomDataSource(*args, seed=7, n_samples=5))
    _same_batches(got, want)


class _RV(object):
    def __init__(self, source, decorators):
        self.source = source
        self.decorators = decorators


CHAINS = {
    'none': [],
    'multi_pass': [('multi_pass', 2)],
    'shuffle': [('shuffle', 4)],
    'batch_partial': [('batch', 4)],
    'parallel': [('parallel', None)],
    'double_buffer_cpu': [('batch', 3), ('double_buffer', 'cpu')],
    'shuffle_batch_buffer': [('multi_pass', 2), ('shuffle', 5),
                             ('batch', 4), ('double_buffer', 'cpu')],
    'batch_parallel': [('batch', 2), ('parallel', None)],
}


@pytest.mark.parametrize('chain', sorted(CHAINS))
def test_decorator_chain_equals_paddle_tpu(tmp_path, chain):
    """iterate_reader over one PTRC file (11 samples, a sequence slot
    among them where the chain does not stack) against
    paddle_tpu.reader_io.iterate_reader, the shuffle seeded alike."""
    path = str(tmp_path / 'c.rio')
    stacks = any(k == 'batch' for k, _ in CHAINS[chain])
    rng = np.random.RandomState(5)
    with t_rio.RecordIOWriter(path) as w:
        for i in range(11):
            slots = [rng.randn(2, 3).astype('float32'),
                     np.asarray([i], 'int64')]
            if not stacks:
                slots.append(('__seq__', rng.randint(0, 9, (1, 8, 1)),
                              np.asarray([3 + i % 4], 'int32'), None))
            w.write(pickle.dumps(slots, protocol=4))
    out = {}
    for pkg, rio in ((fluid, j_rio), (pt, t_rio)):
        decs = [(k, pkg.CPUPlace() if a == 'cpu' else a)
                for k, a in CHAINS[chain]]
        random.seed(11)
        out[pkg] = list(rio.iterate_reader(_RV(
            rio.RecordIOSource(path, None, None, None), decs)))
    _same_batches(out[pt], out[fluid])
    if chain == 'batch_partial':
        assert [b[0].shape[0] for b in out[pt]] == [4, 4, 3]
    if 'double_buffer' in chain:
        assert all(isinstance(v, torch.Tensor) for b in out[pt] for v in b)


def test_parallel_reader_propagates_source_errors():
    class BadSource(object):
        def __iter__(self):
            yield (np.zeros((1,), 'float32'),)
            raise IOError('recordio crc mismatch (synthetic)')

    for kind in ('parallel', 'double_buffer'):
        it = t_rio.iterate_reader(_RV(BadSource(), [(kind, None)]))
        next(it)
        with pytest.raises(IOError, match='synthetic'):
            next(it)


# ---- the reference's recordio layout (recordio_compat) ---------------------------
@pytest.mark.skipif(not os.path.isdir(REF_DIR),
                    reason='reference fixtures unavailable')
def test_reads_real_reference_written_files():
    recs = list(t_rc.read_reference_records(
        os.path.join(REF_DIR, 'test_recordio_creator.dat')))
    assert recs == [str(i).encode() for i in range(10)]
    recs = list(t_rc.read_reference_records(
        os.path.join(REF_DIR, 'test_reader_recordio.dat')))
    assert [pickle.loads(r) for r in recs] == [(1, 2, 3), (4, 5, 6)]


@pytest.mark.parametrize('comp', [t_rc.NO_COMPRESS, t_rc.SNAPPY,
                                  t_rc.GZIP])
def test_reference_layout_round_trip_equals_paddle_tpu(tmp_path, comp):
    payloads = [b'a', b'bc' * 1000, b'', bytes(range(256)) + b'x']
    for rc, name in ((t_rc, 't'), (j_rc, 'j')):
        with rc.ReferenceRecordIOWriter(str(tmp_path / name), comp,
                                        max_num_records=3) as w:
            for p in payloads:
                w.write(p)
    t_bytes = (tmp_path / 't').read_bytes()
    if comp != t_rc.GZIP:              # gzip stamps the time
        assert t_bytes == (tmp_path / 'j').read_bytes()
    for name in ('t', 'j'):
        assert list(t_rc.read_reference_records(
            str(tmp_path / name))) == payloads
        assert list(j_rc.read_reference_records(
            str(tmp_path / name))) == payloads
    assert t_rc.is_reference_recordio(str(tmp_path / 't'))


def test_lod_tensor_record_equals_paddle_tpu():
    a = np.arange(12, dtype='float32').reshape(3, 4)
    b = np.array([[1], [2], [3], [4], [5]], dtype='int64')
    rec = t_rc.pack_lod_tensor_record([a, (b, [[0, 2, 5]])])
    assert rec == j_rc.pack_lod_tensor_record([a, (b, [[0, 2, 5]])])
    (a2, lod_a), (b2, lod_b) = t_rc.unpack_lod_tensor_record(rec)
    np.testing.assert_array_equal(a2, a)
    assert a2.dtype == np.float32 and lod_a == []
    np.testing.assert_array_equal(b2, b)
    assert b2.dtype == np.int64 and lod_b == [[0, 2, 5]]


def test_snappy_codec_equals_paddle_tpu():
    buf = bytes([10]) + bytes([(2 - 1) << 2]) + b'ab' + \
        bytes([((8 - 1) << 2) | 2]) + (2).to_bytes(2, 'little')
    assert t_rc._snappy_raw_decompress(buf) == b'ababababab'
    buf = bytes([8]) + bytes([(4 - 1) << 2]) + b'wxyz' + \
        bytes([((4 - 4) << 2) | 1, 4])
    assert t_rc._snappy_raw_decompress(buf) == b'wxyzwxyz'
    data = b'the quick brown fox ' * 4096
    framed = t_rc._snappy_frame_compress(data)
    assert framed == j_rc._snappy_frame_compress(data)
    assert t_rc._snappy_frame_decompress(framed) == data
    assert t_rc._crc32c(data) == j_rc._crc32c(data)


def test_recordio_source_reads_reference_layout_like_paddle_tpu(tmp_path):
    path = str(tmp_path / 'ref.rio')
    img = np.random.RandomState(0).randn(4, 3).astype('float32')
    seq = np.arange(6, dtype='int64').reshape(6, 1)
    with t_rc.ReferenceRecordIOWriter(path, t_rc.SNAPPY) as w:
        w.write(t_rc.pack_lod_tensor_record([img, (seq, [[0, 2, 6]])]))
        w.write(t_rc.pack_lod_tensor_record([img + 1,
                                             (seq * 2, [[0, 3, 6]])]))
    args = ([[4, 3], [1]], ['float32', 'int64'], [0, 1])
    got = list(t_rio.RecordIOSource(path, *args))
    want = list(j_rio.RecordIOSource(path, *args))
    _same_batches(got, want)
    assert got[0][1].recursive_sequence_lengths() == [[2, 4]]
    np.testing.assert_array_equal(got[0][1].to_dense_rows(), seq)


def test_convert_reader_reference_layout_equals_paddle_tpu(tmp_path):
    reader = _sample_reader(n_batches=3, with_seq=True, seed=4)
    paths = {}
    for pkg, rw in ((fluid, j_rw), (pt, t_rw)):
        paths[pkg] = str(tmp_path / ('%s.rio' % pkg.__name__))
        assert rw.convert_reader_to_recordio_file(
            paths[pkg], reader, _feeder(pkg, True), layout='reference') == 3
    assert open(paths[pt], 'rb').read() == open(paths[fluid], 'rb').read()
    assert t_rc.is_reference_recordio(paths[pt])
    args = ([[6], [1], [1]], ['float32', 'int64', 'int64'], [0, 0, 1])
    _same_batches(list(t_rio.RecordIOSource(paths[pt], *args)),
                  list(j_rio.RecordIOSource(paths[fluid], *args)))
