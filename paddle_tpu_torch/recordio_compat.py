"""Reference recordio binary-format compatibility (pure Python codec).

Counterpart of paddle_tpu/recordio_compat.py, the same codec. Parity:
paddle/fluid/recordio/{header.cc,chunk.cc} (chunk layout),
paddle/fluid/framework/lod_tensor.cc:243-322 (LoDTensor record payload,
WriteToRecordIO/ReadFromRecordIO) and tensor_util.cc:228-276
(TensorToStream): files written by the reference writer are readable
(and writable) here. The PTRC format (reader_io.py /
native/recordio.cc) stays the fast path; this module is the interop
boundary.

Two header layouts exist in the reference tree:

- fluid (header.cc Header::Write): magic, num_records, checksum,
  compressor, compress_size — all uint32 LE.
- legacy v2 (the pip ``recordio`` package that wrote
  python/paddle/reader/tests/test_recordio_creator.dat): magic,
  checksum, compressor, compress_size, num_records.

Both are sniffed per chunk (the compressor enum + payload-size fit
disambiguates; the checksum — zlib crc32 over the STORED payload —
settles any tie). Compressors: 0 none, 1 snappy (framing format, as
vendored snappystream emits: "sNaPpY" stream id + crc32c-masked
chunks), 2 gzip. The snappy raw decoder is complete (literals + all
three copy tags); the encoder emits literal-only blocks, which is valid
snappy any conforming decoder (including the reference's) accepts.
"""
import gzip as _gzip
import struct
import zlib

import numpy as np

MAGIC = 0x01020304
NO_COMPRESS, SNAPPY, GZIP = 0, 1, 2

# VarType.Type (framework.proto) <-> numpy
_PROTO_TO_NP = {0: 'bool', 1: 'int16', 2: 'int32', 3: 'int64',
                4: 'float16', 5: 'float32', 6: 'float64', 20: 'uint8'}
_NP_TO_PROTO = {np.dtype(v): k for k, v in _PROTO_TO_NP.items()}


# ---- crc32c (Castagnoli) + snappy framing mask ----------------------------------
# optional accelerators, used where they are installed
try:  # pragma: no cover - environment-dependent
    import google_crc32c as _gcrc
except ImportError:
    _gcrc = None
try:  # pragma: no cover - environment-dependent
    import snappy as _pysnappy
except ImportError:
    _pysnappy = None

_CRC32C_TABLES = None


def _crc32c_tables():
    """Slicing-by-8 tables: 8 lookups per 8 input bytes instead of a
    per-byte Python loop (~8x on the pure-Python path)."""
    global _CRC32C_TABLES
    if _CRC32C_TABLES is None:
        t0 = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            t0.append(c)
        tables = [t0]
        for k in range(1, 8):
            prev = tables[k - 1]
            tables.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF]
                           for i in range(256)])
        _CRC32C_TABLES = tables
    return _CRC32C_TABLES


def _crc32c(data):
    if _gcrc is not None:  # pragma: no cover - environment-dependent
        return _gcrc.value(bytes(data))
    t = _crc32c_tables()
    t0, t1, t2, t3, t4, t5, t6, t7 = t
    c = 0xFFFFFFFF
    n = len(data)
    i = 0
    while i + 8 <= n:
        c ^= int.from_bytes(data[i:i + 4], 'little')
        b4, b5, b6, b7 = data[i + 4], data[i + 5], data[i + 6], data[i + 7]
        c = (t7[c & 0xFF] ^ t6[(c >> 8) & 0xFF] ^
             t5[(c >> 16) & 0xFF] ^ t4[(c >> 24) & 0xFF] ^
             t3[b4] ^ t2[b5] ^ t1[b6] ^ t0[b7])
        i += 8
    while i < n:
        c = t0[(c ^ data[i]) & 0xFF] ^ (c >> 8)
        i += 1
    return c ^ 0xFFFFFFFF


def _mask_crc(crc):
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- raw snappy -----------------------------------------------------------------
def _snappy_raw_decompress(buf):
    if _pysnappy is not None:  # pragma: no cover - environment-dependent
        return _pysnappy.uncompress(bytes(buf))
    pos, ulen, shift = 0, 0, 0
    while True:
        b = buf[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        t = tag & 3
        if t == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                nb = ln - 60
                ln = int.from_bytes(buf[pos:pos + nb], 'little') + 1
                pos += nb
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if t == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif t == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 2], 'little')
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], 'little')
            pos += 4
        if off == 0:
            raise IOError("snappy: zero copy offset")
        while ln > 0:  # overlapping copies replicate the tail
            take = min(ln, off)
            out += out[-off:len(out) - off + take]
            ln -= take
    if len(out) != ulen:
        raise IOError("snappy: length mismatch (%d != %d)"
                      % (len(out), ulen))
    return bytes(out)


def _snappy_raw_compress(data):
    """Literal-only snappy (valid per the format spec; no copies)."""
    out = bytearray()
    ulen = len(data)
    while True:  # preamble: varint uncompressed length
        b = ulen & 0x7F
        ulen >>= 7
        out.append(b | (0x80 if ulen else 0))
        if not ulen:
            break
    pos = 0
    while pos < len(data):
        # callers feed <=64 KiB framing blocks; the cap is a safety bound
        ln = min(len(data) - pos, 1 << 20)
        if ln <= 60:
            out.append((ln - 1) << 2)
        else:
            nb = (max(ln - 1, 1).bit_length() + 7) // 8
            out.append((59 + nb) << 2)
            out += (ln - 1).to_bytes(nb, 'little')
        out += data[pos:pos + ln]
        pos += ln
    return bytes(out)


# ---- snappy framing format ------------------------------------------------------
_STREAM_ID = b'\xff\x06\x00\x00sNaPpY'


def _snappy_frame_decompress(buf):
    pos, out = 0, bytearray()
    n = len(buf)
    while pos < n:
        ctype = buf[pos]
        ln = int.from_bytes(buf[pos + 1:pos + 4], 'little')
        pos += 4
        chunk = buf[pos:pos + ln]
        pos += ln
        if ctype == 0xFF:
            if chunk != b'sNaPpY':
                raise IOError("snappy framing: bad stream identifier")
        elif ctype in (0x00, 0x01):
            crc = int.from_bytes(chunk[:4], 'little')
            data = chunk[4:]
            if ctype == 0x00:
                data = _snappy_raw_decompress(data)
            if _mask_crc(_crc32c(data)) != crc:
                raise IOError("snappy framing: crc32c mismatch")
            out += data
        elif ctype == 0xFE or 0x80 <= ctype <= 0xFD:
            continue  # padding / skippable
        else:
            raise IOError("snappy framing: unskippable chunk 0x%02x"
                          % ctype)
    return bytes(out)


def _snappy_frame_compress(data):
    out = bytearray(_STREAM_ID)
    pos = 0
    while pos < len(data) or pos == 0:
        block = data[pos:pos + 65536]
        pos += 65536
        crc = _mask_crc(_crc32c(block))
        comp = _snappy_raw_compress(block)
        if len(comp) < len(block):
            body = crc.to_bytes(4, 'little') + comp
            out += bytes([0x00]) + len(body).to_bytes(3, 'little') + body
        else:
            body = crc.to_bytes(4, 'little') + bytes(block)
            out += bytes([0x01]) + len(body).to_bytes(3, 'little') + body
        if pos >= len(data):
            break
    return bytes(out)


# ---- chunk layer ----------------------------------------------------------------
def read_reference_records(path):
    """Iterate raw record payloads from a reference recordio file,
    sniffing fluid vs legacy header order per chunk and verifying the
    zlib-crc32 chunk checksum."""
    with open(path, 'rb') as f:
        while True:
            hdr = f.read(20)
            if len(hdr) < 20:
                return
            magic, w1, w2, w3, w4 = struct.unpack('<5I', hdr)
            if magic != MAGIC:
                raise IOError("%s: bad recordio magic 0x%08x"
                              % (path, magic))
            # fluid: num, sum, comp, size / legacy: sum, comp, size, num
            candidates = []
            if w3 in (NO_COMPRESS, SNAPPY, GZIP):
                candidates.append((w1, w2, w3, w4))
            if w2 in (NO_COMPRESS, SNAPPY, GZIP):
                candidates.append((w4, w1, w2, w3))
            payload = None
            parsed = None
            for num, csum, comp, size in candidates:
                pos = f.tell()
                data = f.read(size)
                if len(data) == size and \
                        (zlib.crc32(data) & 0xFFFFFFFF) == csum:
                    payload, parsed = data, (num, comp)
                    break
                f.seek(pos)
            if payload is None:
                raise IOError("%s: no header interpretation matches "
                              "the chunk checksum" % path)
            num, comp = parsed
            if comp == SNAPPY:
                payload = _snappy_frame_decompress(payload)
            elif comp == GZIP:
                payload = _gzip.decompress(payload)
            pos = 0
            for _ in range(num):
                (sz,) = struct.unpack_from('<I', payload, pos)
                pos += 4
                yield payload[pos:pos + sz]
                pos += sz


class ReferenceRecordIOWriter(object):
    """Writes the fluid chunk layout (header.cc order). Records are
    buffered and flushed max_num_records per chunk, like the reference
    Writer."""

    def __init__(self, path, compressor=SNAPPY, max_num_records=1000):
        self.f = open(path, 'wb')
        self.compressor = compressor
        self.max_num_records = max_num_records
        self._records = []

    def write(self, record_bytes):
        self._records.append(bytes(record_bytes))
        if len(self._records) >= self.max_num_records:
            self.flush()

    def flush(self):
        if not self._records:
            return
        payload = b''.join(
            struct.pack('<I', len(r)) + r for r in self._records)
        if self.compressor == SNAPPY:
            payload = _snappy_frame_compress(payload)
        elif self.compressor == GZIP:
            payload = _gzip.compress(payload)
        self.f.write(struct.pack(
            '<5I', MAGIC, len(self._records),
            zlib.crc32(payload) & 0xFFFFFFFF, self.compressor,
            len(payload)))
        self.f.write(payload)
        self._records = []

    def close(self):
        self.flush()
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---- LoDTensor record payload ---------------------------------------------------
def _write_varint(out, v):
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _read_varint(buf, pos):
    v, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def serialize_lod_tensor(arr, lod=None):
    """One LoDTensor stream (lod_tensor.cc SerializeToStream +
    tensor_util.cc TensorToStream). ``lod``: list of offset lists."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_PROTO:
        raise TypeError("unsupported dtype %s" % arr.dtype)
    out = bytearray()
    out += struct.pack('<I', 0)                     # LoDTensor version
    lod = lod or []
    out += struct.pack('<Q', len(lod))
    for level in lod:
        level = [int(x) for x in level]
        out += struct.pack('<Q', len(level) * 8)
        out += struct.pack('<%dQ' % len(level), *level)
    out += struct.pack('<I', 0)                     # Tensor version
    desc = bytearray()
    desc.append(0x08)                               # field 1 varint
    _write_varint(desc, _NP_TO_PROTO[arr.dtype])
    for d in arr.shape:
        desc.append(0x10)                           # field 2 varint
        _write_varint(desc, int(d))
    out += struct.pack('<i', len(desc))
    out += desc
    out += arr.tobytes()
    return bytes(out)


def _parse_tensor_desc(buf):
    dtype, dims, pos = None, [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if fno == 1 and wt == 0:
            v, pos = _read_varint(buf, pos)
            dtype = v
        elif fno == 2 and wt == 0:
            v, pos = _read_varint(buf, pos)
            dims.append(v)
        elif fno == 2 and wt == 2:  # packed
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                dims.append(v)
        elif wt == 0:
            _, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            pos += ln
        else:
            raise IOError("TensorDesc: unsupported wire type %d" % wt)
    return dtype, dims


def deserialize_lod_tensor(buf, pos=0):
    """Returns ((ndarray, lod), new_pos)."""
    (version,) = struct.unpack_from('<I', buf, pos)
    pos += 4
    if version != 0:
        raise IOError("LoDTensor version %d unsupported" % version)
    (n_levels,) = struct.unpack_from('<Q', buf, pos)
    pos += 8
    lod = []
    for _ in range(n_levels):
        (nbytes,) = struct.unpack_from('<Q', buf, pos)
        pos += 8
        n = nbytes // 8
        lod.append(list(struct.unpack_from('<%dQ' % n, buf, pos)))
        pos += nbytes
    (tversion,) = struct.unpack_from('<I', buf, pos)
    pos += 4
    if tversion != 0:
        raise IOError("Tensor version %d unsupported" % tversion)
    (desc_size,) = struct.unpack_from('<i', buf, pos)
    pos += 4
    dtype_id, dims = _parse_tensor_desc(bytes(buf[pos:pos + desc_size]))
    pos += desc_size
    if dtype_id not in _PROTO_TO_NP:
        raise IOError("unsupported VarType %s" % dtype_id)
    dt = np.dtype(_PROTO_TO_NP[dtype_id])
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(
        buf, dtype=dt, count=count, offset=pos).reshape(dims).copy()
    pos += count * dt.itemsize
    return (arr, lod), pos


def pack_lod_tensor_record(tensors):
    """WriteToRecordIO: uint32 count + concatenated LoDTensor streams.
    ``tensors``: list of ndarray or (ndarray, lod) pairs."""
    out = bytearray(struct.pack('<I', len(tensors)))
    for t in tensors:
        arr, lod = t if isinstance(t, tuple) else (t, None)
        out += serialize_lod_tensor(arr, lod)
    return bytes(out)


def unpack_lod_tensor_record(record):
    """ReadFromRecordIO: one record -> list of (ndarray, lod)."""
    (count,) = struct.unpack_from('<I', record, 0)
    pos, out = 4, []
    for _ in range(count):
        item, pos = deserialize_lod_tensor(record, pos)
        out.append(item)
    return out


def is_reference_recordio(path):
    with open(path, 'rb') as f:
        head = f.read(4)
    return len(head) == 4 and \
        struct.unpack('<I', head)[0] == MAGIC
