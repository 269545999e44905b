"""Binary USD (usdc, "crate") file reader and writer.

Port of ``kaolin_tpu/io/usdc.py``, numpy only: the same reader **and
writer** for the Pixar crate format (no ``pxr`` dependency), covering the
subset the reference's I/O layer exercises -- mesh / pointcloud /
voxelgrid prims with default values and time samples, i.e. everything
``Timelapse`` writes. Parsed files are loaded into the in-memory
:class:`kaolin_tpu_torch.io.usd.Stage` prim tree the usda parser
produces, so every importer works unchanged on binary files;
:func:`write_usdc` serializes a Stage back to crate (version 0.8.0
layout). From the same stage it writes the same bytes as
``kaolin_tpu``'s writer: tokens, fields and paths are emitted in the
same order.

Format notes (crate version 0.8.0; layout per pxr's ``crateFile.cpp``):

- header: ``PXR-USDC`` magic, u8 version triple, u64 TOC offset.
- TOC sections: TOKENS / STRINGS / FIELDS / FIELDSETS / PATHS / SPECS.
- compression: LZ4 blocks with a 1-byte chunk-count framing; integer
  streams additionally use USD's delta coding (common int32 + 2-bit
  per-value size codes + variable-width deltas, running-summed).
- a ``ValueRep`` is a u64: bit63 array, bit62 inlined, bit61
  compressed, bits 48-55 type enum, low 48 bits payload
  (inline value or file offset).
"""

import struct

import numpy as np

__all__ = ['read_usdc', 'write_usdc', 'is_usdc']

# crate type enum (crateDataTypes.h order), subset we interpret
_BOOL, _UCHAR, _INT, _UINT, _INT64, _UINT64 = 1, 2, 3, 4, 5, 6
_HALF, _FLOAT, _DOUBLE, _STRING, _TOKEN, _ASSET = 7, 8, 9, 10, 11, 12
_MAT2D, _MAT3D, _MAT4D = 13, 14, 15
_QUATD, _QUATF, _QUATH = 16, 17, 18
_VEC2D, _VEC2F, _VEC2H, _VEC2I = 19, 20, 21, 22
_VEC3D, _VEC3F, _VEC3H, _VEC3I = 23, 24, 25, 26
_VEC4D, _VEC4F, _VEC4H, _VEC4I = 27, 28, 29, 30
_DICT = 31
_TOKEN_VECTOR = 41
_SPECIFIER = 42
_VARIABILITY = 44
_TIME_SAMPLES = 46
_DOUBLE_VECTOR = 48

_SCALAR_DTYPES = {
    _BOOL: np.dtype('<u1'), _UCHAR: np.dtype('<u1'),
    _INT: np.dtype('<i4'), _UINT: np.dtype('<u4'),
    _INT64: np.dtype('<i8'), _UINT64: np.dtype('<u8'),
    _HALF: np.dtype('<f2'), _FLOAT: np.dtype('<f4'),
    _DOUBLE: np.dtype('<f8'),
}
# (element dtype, tuple arity)
_VEC_DTYPES = {
    _VEC2D: ('<f8', 2), _VEC2F: ('<f4', 2), _VEC2H: ('<f2', 2),
    _VEC2I: ('<i4', 2),
    _VEC3D: ('<f8', 3), _VEC3F: ('<f4', 3), _VEC3H: ('<f2', 3),
    _VEC3I: ('<i4', 3),
    _VEC4D: ('<f8', 4), _VEC4F: ('<f4', 4), _VEC4H: ('<f2', 4),
    _VEC4I: ('<i4', 4),
    _MAT2D: ('<f8', 4), _MAT3D: ('<f8', 9), _MAT4D: ('<f8', 16),
    _QUATD: ('<f8', 4), _QUATF: ('<f4', 4), _QUATH: ('<f2', 4),
}

_SPEC_PSEUDO_ROOT = 7
_SPEC_PRIM = 6
_SPEC_ATTRIBUTE = 1


def is_usdc(file_path):
    with open(file_path, 'rb') as fh:
        return fh.read(8) == b'PXR-USDC'


def _lz4_block(src):
    """Raw LZ4 block decode."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - off
        for k in range(mlen):
            out.append(out[start + k])
    return bytes(out)


def _decompress(buf):
    """TfFastCompression framing: 1 chunk-count byte (0 = single
    unframed block), then per-chunk i32 size + LZ4 block."""
    nchunks = buf[0]
    if nchunks == 0:
        return _lz4_block(buf[1:])
    out = b''
    i = 1
    for _ in range(nchunks):
        sz = struct.unpack('<i', buf[i:i + 4])[0]
        i += 4
        out += _lz4_block(buf[i:i + sz])
        i += sz
    return out


def _decode_ints(buf, n):
    """Usd_IntegerCompression (32-bit): lz4(common delta + 2-bit codes +
    variable-width deltas), running-summed."""
    if n == 0:
        return np.zeros(0, np.int64)
    data = _decompress(buf)
    common = struct.unpack('<i', data[:4])[0]
    ncode = (2 * n + 7) // 8
    codes = np.frombuffer(data[4:4 + ncode], np.uint8)
    codes = (codes[:, None] >> np.array([0, 2, 4, 6], np.uint8)[None]) & 3
    codes = codes.reshape(-1)[:n]
    vals = data[4 + ncode:]
    sizes = np.choose(codes, [0, 1, 2, 4])
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    deltas = np.full(n, common, np.int64)
    vb = np.frombuffer(vals, np.uint8)
    for code, dt in ((1, np.int8), (2, np.dtype('<i2')), (3,
                                                          np.dtype('<i4'))):
        m = codes == code
        if not m.any():
            continue
        o = offs[m]
        w = np.dtype(dt).itemsize
        raw = vb[o[:, None] + np.arange(w)[None]].tobytes()
        deltas[m] = np.frombuffer(raw, dt).astype(np.int64)
    return np.cumsum(deltas)


class _Crate:
    def __init__(self, data):
        self.f = data
        magic = data[:8]
        if magic != b'PXR-USDC':
            raise ValueError('not a usdc file')
        self.version = tuple(data[8:11])
        if self.version < (0, 4, 0):
            raise NotImplementedError(
                f'crate version {self.version} predates the compressed '
                'layout; re-export with a newer USD')
        toc_off, = struct.unpack('<Q', data[16:24])
        nsec, = struct.unpack('<Q', data[toc_off:toc_off + 8])
        self.sections = {}
        off = toc_off + 8
        for _ in range(nsec):
            name = data[off:off + 16].split(b'\0')[0].decode()
            o, s = struct.unpack('<QQ', data[off + 16:off + 32])
            self.sections[name] = (o, s)
            off += 32
        self._read_tokens()
        self._read_strings()
        self._read_fields()
        self._read_fieldsets()
        self._read_paths()
        self._read_specs()

    # --- section readers ---------------------------------------------
    def _u64(self, off):
        return struct.unpack('<Q', self.f[off:off + 8])[0]

    def _compressed_ints(self, off, n):
        """u64 compressed-size + buffer at ``off``; returns (ints,
        offset past the buffer)."""
        csz = self._u64(off)
        return _decode_ints(self.f[off + 8:off + 8 + csz], n), off + 8 + csz

    def _read_tokens(self):
        o, _ = self.sections['TOKENS']
        ntok, _usz, csz = struct.unpack('<QQQ', self.f[o:o + 24])
        blob = _decompress(self.f[o + 24:o + 24 + csz])
        self.tokens = [t.decode('utf-8', 'replace')
                       for t in blob.split(b'\0')[:ntok]]

    def _read_strings(self):
        o, s = self.sections.get('STRINGS', (None, 0))
        self.strings = []
        if o is None:
            return
        cnt = self._u64(o)
        idx = np.frombuffer(self.f[o + 8:o + 8 + 4 * cnt], '<u4')
        self.strings = [self.tokens[i] for i in idx]

    def _read_fields(self):
        o, _ = self.sections['FIELDS']
        nf = self._u64(o)
        tok_idx, p = self._compressed_ints(o + 8, nf)
        repsz = self._u64(p)
        reps = np.frombuffer(_decompress(self.f[p + 8:p + 8 + repsz]),
                             '<u8', nf)
        self.fields = [(self.tokens[tok_idx[i]], int(reps[i]))
                       for i in range(nf)]

    def _read_fieldsets(self):
        o, _ = self.sections['FIELDSETS']
        nfs = self._u64(o)
        flat, _ = self._compressed_ints(o + 8, nfs)
        # runs of field indices terminated by -1; keyed by start index
        self.fieldsets = {}
        start = 0
        for i, v in enumerate(flat):
            if v == -1 or v == 0xFFFFFFFF:
                self.fieldsets[start] = [int(x) for x in flat[start:i]]
                start = i + 1

    def _read_paths(self):
        o, _ = self.sections['PATHS']
        npaths = self._u64(o)
        n = self._u64(o + 8)
        path_idx, p = self._compressed_ints(o + 16, n)
        elem_tok, p = self._compressed_ints(p, n)
        jumps, p = self._compressed_ints(p, n)
        self.paths = [''] * npaths

        # pxr _BuildDecompressedPathsImpl: preorder with explicit sibling
        # jump offsets
        stack = [(0, None)]              # (entry index, parent path)
        while stack:
            cur, parent = stack.pop()
            while True:
                this = cur
                cur += 1
                if parent is None:
                    path = '/'
                else:
                    tok = self.tokens[abs(int(elem_tok[this]))]
                    sep = '.' if elem_tok[this] < 0 else (
                        '' if parent == '/' else '/')
                    base = '' if parent == '/' else parent
                    path = (base + sep + tok) if elem_tok[this] < 0 \
                        else (base + '/' + tok)
                self.paths[path_idx[this]] = path
                has_child = jumps[this] > 0 or jumps[this] == -1
                has_sibling = jumps[this] >= 0
                if has_child:
                    if has_sibling:
                        stack.append((this + int(jumps[this]), parent))
                    parent = path
                elif has_sibling:
                    continue
                else:
                    break

    def _read_specs(self):
        o, _ = self.sections['SPECS']
        n = self._u64(o)
        path_idx, p = self._compressed_ints(o + 8, n)
        fset_idx, p = self._compressed_ints(p, n)
        spec_ty, p = self._compressed_ints(p, n)
        self.specs = [(int(a), int(b), int(c))
                      for a, b, c in zip(path_idx, fset_idx, spec_ty)]

    # --- value decoding ------------------------------------------------
    def _rep(self, r):
        return ((r >> 48) & 0xFF, bool(r >> 63 & 1), bool(r >> 62 & 1),
                bool(r >> 61 & 1), r & ((1 << 48) - 1))

    def _read_int_array(self, off, dtype, compressed):
        cnt = self._u64(off)
        if not compressed:
            w = np.dtype(dtype).itemsize
            return np.frombuffer(self.f[off + 8:off + 8 + w * cnt],
                                 dtype, cnt).copy()
        ints, _ = self._compressed_ints(off + 8, cnt)
        return ints.astype(dtype)

    def _read_float_array(self, off, dtype, compressed):
        cnt = self._u64(off)
        if not compressed:
            w = np.dtype(dtype).itemsize
            return np.frombuffer(self.f[off + 8:off + 8 + w * cnt],
                                 dtype, cnt).copy()
        code = self.f[off + 8:off + 9]
        if code == b'i':                 # all-integral values
            ints, _ = self._compressed_ints(off + 9, cnt)
            return ints.astype(dtype)
        if code == b't':                 # small lookup table + indices
            lut_n = struct.unpack('<I', self.f[off + 9:off + 13])[0]
            w = np.dtype(dtype).itemsize
            lut = np.frombuffer(self.f[off + 13:off + 13 + w * lut_n],
                                dtype, lut_n)
            idx, _ = self._compressed_ints(off + 13 + w * lut_n, cnt)
            return lut[idx]
        raise NotImplementedError(f'float array code {code!r}')

    def value(self, rep):
        """Decodes a ValueRep into a python value (numpy for arrays)."""
        ty, is_array, inlined, compressed, payload = self._rep(rep)
        if ty == _TIME_SAMPLES:
            return self._time_samples(payload)
        if is_array:
            if ty in _SCALAR_DTYPES:
                dt = _SCALAR_DTYPES[ty]
                if np.issubdtype(dt, np.integer):
                    arr = self._read_int_array(payload, dt, compressed)
                else:
                    arr = self._read_float_array(payload, dt, compressed)
                return arr
            if ty in _VEC_DTYPES:
                dt, k = _VEC_DTYPES[ty]
                cnt = self._u64(payload)
                w = np.dtype(dt).itemsize
                arr = np.frombuffer(
                    self.f[payload + 8:payload + 8 + w * k * cnt], dt,
                    k * cnt).reshape(cnt, k).copy()
                return arr
            if ty in (_TOKEN, _STRING, _ASSET):
                cnt = self._u64(payload)
                idx = np.frombuffer(
                    self.f[payload + 8:payload + 8 + 4 * cnt], '<u4')
                src = self.strings if ty == _STRING else self.tokens
                return [src[i] for i in idx]
            raise NotImplementedError(f'array type {ty}')
        if inlined:
            if ty == _TOKEN:
                return self.tokens[payload]
            if ty == _STRING:
                return self.strings[payload]
            if ty == _ASSET:
                return self.tokens[payload]
            if ty == _BOOL:
                return bool(payload & 1)
            if ty in (_INT, _UINT, _INT64, _UINT64, _UCHAR):
                v = np.int64(np.uint64(payload & 0xFFFFFFFF))
                if ty in (_INT, _INT64):
                    v = np.int32(np.uint32(payload & 0xFFFFFFFF))
                return int(v)
            if ty in (_FLOAT, _DOUBLE):
                # inline floats/doubles store the value's float32 bits
                return float(np.uint32(payload & 0xFFFFFFFF).view(
                    np.float32))
            if ty == _HALF:
                return float(np.uint16(payload & 0xFFFF).view(np.float16))
            if ty in _VEC_DTYPES:
                _, k = _VEC_DTYPES[ty]
                b = struct.pack('<Q', payload)[:k]
                return np.frombuffer(b, np.int8, k).astype(np.float64)
            if ty in (_SPECIFIER, _VARIABILITY):
                return int(payload)
            if ty == _DICT:
                return {}
            raise NotImplementedError(f'inline type {ty}')
        # out-of-line scalars / vectors
        if ty in _SCALAR_DTYPES:
            dt = _SCALAR_DTYPES[ty]
            w = np.dtype(dt).itemsize
            return np.frombuffer(self.f[payload:payload + w], dt, 1)[0]
        if ty in _VEC_DTYPES:
            dt, k = _VEC_DTYPES[ty]
            w = np.dtype(dt).itemsize
            return np.frombuffer(self.f[payload:payload + w * k], dt,
                                 k).copy()
        if ty == _TOKEN_VECTOR:
            cnt = self._u64(payload)
            idx = np.frombuffer(self.f[payload + 8:payload + 8 + 4 * cnt],
                                '<u4')
            return [self.tokens[i] for i in idx]
        if ty == _DOUBLE_VECTOR:
            cnt = self._u64(payload)
            return np.frombuffer(self.f[payload + 8:payload + 8 + 8 * cnt],
                                 '<f8', cnt).copy()
        raise NotImplementedError(f'type {ty} (array={is_array})')

    def _time_samples(self, off):
        """[u64 sz][times data ...][u64 timesRep]  — sz includes the rep —
        then [u64 8][u64 n][n x u64 valueReps]."""
        sz = self._u64(off)
        times_rep = self._u64(off + 8 + sz - 8)
        times = np.asarray(self.value(times_rep), np.float64)
        p = off + 8 + sz
        p += 8                                     # values-section size
        n = self._u64(p)
        reps = struct.unpack(f'<{n}Q', self.f[p + 8:p + 8 + 8 * n])
        return {float(t): self.value(r) for t, r in zip(times, reps)}

    def spec_fields(self, fset_idx):
        out = {}
        for fi in self.fieldsets.get(fset_idx, []):
            name, rep = self.fields[fi]
            out[name] = rep
        return out


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _lz4_literal_block(data):
    """Encodes ``data`` as a single literal-only LZ4 sequence (always a
    valid block: the final sequence of a block carries literals only)."""
    out = bytearray()
    lit = len(data)
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        rem = lit - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += data
    return bytes(out)


def _compress(data):
    """Inverse of :func:`_decompress` (chunk-count byte 0 = one block)."""
    return b'\0' + _lz4_literal_block(data)


def _encode_ints(vals):
    """Inverse of :func:`_decode_ints`: delta-code + 2-bit size codes,
    LZ4-wrapped. Returns the compressed buffer (without the u64 size)."""
    vals = np.asarray(vals, np.int64)
    n = len(vals)
    if n == 0:
        return _compress(b'')
    deltas = np.diff(np.concatenate([np.zeros(1, np.int64), vals]))
    in32 = deltas[(deltas >= -2**31) & (deltas < 2**31)]
    if len(in32):
        uniq, cnt = np.unique(in32, return_counts=True)
        common = int(uniq[np.argmax(cnt)])
    else:
        common = 0
    codes = np.full(n, 3, np.uint8)                       # i32 default
    codes[deltas == common] = 0
    codes[(codes == 3) & (deltas >= -128) & (deltas < 128)] = 1
    codes[(codes == 3) & (deltas >= -2**15) & (deltas < 2**15)] = 2
    ncode = (2 * n + 7) // 8
    packed = np.zeros(ncode, np.uint8)
    shifted = (codes.astype(np.uint32)
               << (2 * (np.arange(n, dtype=np.uint32) & 3)))
    np.add.at(packed, np.arange(n) // 4, shifted.astype(np.uint8))
    body = bytearray(struct.pack('<i', common))
    body += packed.tobytes()
    # variable-width deltas stored consecutively in value order
    chunks = []
    for i in np.nonzero(codes)[0]:
        d = int(deltas[i])
        chunks.append(struct.pack('<b' if codes[i] == 1 else
                                  '<h' if codes[i] == 2 else '<i', d))
    body += b''.join(chunks)
    return _compress(bytes(body))


# usd_type string (as the usda layer uses) -> crate array element type
_USD_ARRAY_TYPES = {
    'point3f[]': _VEC3F, 'normal3f[]': _VEC3F, 'color3f[]': _VEC3F,
    'float3[]': _VEC3F, 'vector3f[]': _VEC3F,
    'texCoord2f[]': _VEC2F, 'float2[]': _VEC2F,
    'int[]': _INT, 'int64[]': _INT64,
    'float[]': _FLOAT, 'double[]': _DOUBLE,
}


class _CrateWriter:
    """Serializes a ``usd.Stage`` prim tree to crate 0.8.0 bytes,
    emitting exactly the encodings :class:`_Crate` consumes (u64 array
    counts, uncompressed out-of-line arrays, compressed structural
    int streams)."""

    def __init__(self):
        self.buf = bytearray(88)            # bootstrap header space
        self._tokens = {}
        self.tokens = []
        self.token('')                      # index 0 reserved (empty)
        self._strings = {}
        self.strings = []
        self._fields = {}
        self.fields = []                    # (token_idx, rep)
        self.fieldset_flat = []
        self.specs = []                     # (path_idx, fset_start, ty)

    # --- tables ---------------------------------------------------------
    def token(self, t):
        if t not in self._tokens:
            self._tokens[t] = len(self.tokens)
            self.tokens.append(t)
        return self._tokens[t]

    def string(self, s):
        if s not in self._strings:
            self._strings[s] = len(self.strings)
            self.strings.append(self.token(s))
        return self._strings[s]

    def field(self, name, rep):
        key = (self.token(name), rep)
        if key not in self._fields:
            self._fields[key] = len(self.fields)
            self.fields.append(key)
        return self._fields[key]

    def fieldset(self, field_indices):
        start = len(self.fieldset_flat)
        self.fieldset_flat.extend(field_indices)
        self.fieldset_flat.append(-1)
        return start

    # --- value emission ---------------------------------------------------
    def _align(self):
        pad = (-len(self.buf)) % 8
        self.buf += b'\0' * pad

    def _emit(self, data):
        self._align()
        off = len(self.buf)
        self.buf += data
        return off

    @staticmethod
    def _rep(ty, payload, array=False, inlined=False, compressed=False):
        r = (ty & 0xFF) << 48 | (payload & ((1 << 48) - 1))
        if array:
            r |= 1 << 63
        if inlined:
            r |= 1 << 62
        if compressed:
            r |= 1 << 61
        return r

    def token_rep(self, t):
        return self._rep(_TOKEN, self.token(t), inlined=True)

    def token_vector_rep(self, toks):
        idx = [self.token(t) for t in toks]
        data = struct.pack('<Q', len(idx)) + np.asarray(
            idx, '<u4').tobytes()
        return self._rep(_TOKEN_VECTOR, self._emit(data))

    def array_rep(self, usd_type, value):
        ty = _USD_ARRAY_TYPES.get(usd_type)
        arr = np.asarray(value)
        if ty is None:                      # fall back on value shape
            if np.issubdtype(arr.dtype, np.integer):
                ty = _INT
            elif arr.ndim == 2 and arr.shape[1] == 3:
                ty = _VEC3F
            elif arr.ndim == 2 and arr.shape[1] == 2:
                ty = _VEC2F
            else:
                ty = _FLOAT
        if ty in _SCALAR_DTYPES:
            flat = arr.reshape(-1).astype(_SCALAR_DTYPES[ty])
            data = struct.pack('<Q', flat.size) + flat.tobytes()
        else:
            dt, k = _VEC_DTYPES[ty]
            flat = arr.reshape(-1, k).astype(dt)
            data = struct.pack('<Q', flat.shape[0]) + flat.tobytes()
        return self._rep(ty, self._emit(data), array=True)

    def scalar_rep(self, usd_type, value):
        if usd_type == 'bool':
            return self._rep(_BOOL, 1 if value else 0, inlined=True)
        if usd_type == 'int':
            payload = int(np.uint32(np.int32(int(value))))
            return self._rep(_INT, payload, inlined=True)
        if usd_type == 'string':
            return self._rep(_STRING, self.string(str(value)),
                             inlined=True)
        if usd_type == 'token':
            return self.token_rep(str(value))
        v = float(value)
        if usd_type == 'float' or v == float(np.float32(v)):
            ty = _FLOAT if usd_type == 'float' else _DOUBLE
            payload = int(np.float32(v).view(np.uint32))
            return self._rep(ty, payload, inlined=True)
        return self._rep(_DOUBLE, self._emit(struct.pack('<d', v)))

    def value_rep(self, usd_type, value):
        if usd_type.endswith('[]') or isinstance(value, np.ndarray):
            return self.array_rep(usd_type, value)
        return self.scalar_rep(usd_type, value)

    def time_samples_rep(self, usd_type, samples):
        times = sorted(samples)
        value_reps = [self.value_rep(usd_type, samples[t]) for t in times]
        tdata = struct.pack('<Q', len(times)) + np.asarray(
            times, '<f8').tobytes()
        times_rep = self._rep(_DOUBLE_VECTOR, self._emit(tdata))
        n = len(times)
        data = struct.pack('<QQQQ', 8, times_rep, 8 * (n + 1), n)
        data += struct.pack(f'<{n}Q', *value_reps) if n else b''
        return self._rep(_TIME_SAMPLES, self._emit(data))

    # --- sections ---------------------------------------------------------
    def _compressed_ints_block(self, vals):
        enc = _encode_ints(vals)
        return struct.pack('<Q', len(enc)) + enc

    def write_sections(self):
        sections = []

        def section(name, data):
            self._align()
            off = len(self.buf)
            self.buf += data
            sections.append((name, off, len(data)))

        blob = b''.join(t.encode('utf-8') + b'\0' for t in self.tokens)
        comp = _compress(blob)
        section('TOKENS', struct.pack('<QQQ', len(self.tokens),
                                      len(blob), len(comp)) + comp)

        section('STRINGS', struct.pack('<Q', len(self.strings))
                + np.asarray(self.strings, '<u4').tobytes())

        tok_idx = [t for t, _ in self.fields]
        reps = np.asarray([r for _, r in self.fields], '<u8').tobytes()
        creps = _compress(reps)
        section('FIELDS', struct.pack('<Q', len(self.fields))
                + self._compressed_ints_block(tok_idx)
                + struct.pack('<Q', len(creps)) + creps)

        section('FIELDSETS', struct.pack('<Q', len(self.fieldset_flat))
                + self._compressed_ints_block(self.fieldset_flat))

        n = len(self.path_entries)
        section('PATHS', struct.pack('<QQ', n, n)
                + self._compressed_ints_block(
                    [e[0] for e in self.path_entries])
                + self._compressed_ints_block(
                    [e[1] for e in self.path_entries])
                + self._compressed_ints_block(
                    [e[2] for e in self.path_entries]))

        section('SPECS', struct.pack('<Q', len(self.specs))
                + self._compressed_ints_block(
                    [s[0] for s in self.specs])
                + self._compressed_ints_block(
                    [s[1] for s in self.specs])
                + self._compressed_ints_block(
                    [s[2] for s in self.specs]))

        self._align()
        toc_off = len(self.buf)
        self.buf += struct.pack('<Q', len(sections))
        for name, off, size in sections:
            self.buf += name.encode().ljust(16, b'\0')
            self.buf += struct.pack('<QQ', off, size)

        self.buf[0:8] = b'PXR-USDC'
        self.buf[8:16] = bytes((0, 8, 0)) + b'\0' * 5
        self.buf[16:24] = struct.pack('<Q', toc_off)


def _build_paths(writer, stage):
    """Preorder path-tree encoding (inverse of ``_Crate._read_paths``):
    jump = own subtree size when a sibling follows, -1 child-only,
    0 sibling-only, -2 leaf. Returns {path: path_index} with entry
    order as the index (root = 0)."""
    entries = []            # [path_idx, elem_tok_signed, jump]
    path_index = {}

    def emit(path, tok_signed, children):
        idx = len(entries)
        path_index[path] = idx
        entries.append([idx, tok_signed, -2])
        size = 1
        child_sizes = []
        for cpath, ctok, cchildren in children:
            child_sizes.append(emit(cpath, ctok, cchildren))
            size += child_sizes[-1]
        # fix up jumps now that subtree sizes are known
        pos = idx + 1
        for i, csz in enumerate(child_sizes):
            has_sib = i + 1 < len(child_sizes)
            has_child = csz > 1
            if has_child and has_sib:
                entries[pos][2] = csz
            elif has_child:
                entries[pos][2] = -1
            elif has_sib:
                entries[pos][2] = 0
            else:
                entries[pos][2] = -2
            pos += csz
        return size

    def prim_children(prim, path):
        base = '' if path == '/' else path
        kids = []
        for attr in list(prim.attrs) + list(prim.time_attrs):
            kids.append((f'{base}.{attr}' if base else f'/.{attr}',
                         -writer.token(attr), []))
        for name, child in prim.children.items():
            kids.append((f'{base}/{name}', writer.token(name),
                         prim_children(child, f'{base}/{name}')))
        return kids

    root_children = prim_children(stage.root, '/')
    emit('/', 0, root_children)
    entries[0][2] = -1 if root_children else -2
    writer.path_entries = entries
    return path_index


def write_usdc(stage, file_path=None):
    """Serializes a ``usd.Stage`` to a binary usdc (crate 0.8.0) file.

    Counterpart of :func:`read_usdc`; round-trips everything the Stage
    model holds (prim tree, typed default attrs, time samples). The
    reference writes crate through pxr (``kaolin/io/usd.py`` via
    ``Usd.Stage.Save``); this is the pxr-free equivalent.
    """
    w = _CrateWriter()
    path_index = _build_paths(w, stage)

    # pseudo-root spec
    root_fields = []
    if stage.default_prim:
        root_fields.append(w.field('defaultPrim',
                                   w.token_rep(stage.default_prim)))
    root_fields.append(w.field('upAxis', w.token_rep(stage.up_axis)))
    if stage.root.children:
        root_fields.append(w.field('primChildren', w.token_vector_rep(
            list(stage.root.children))))
    w.specs.append((path_index['/'], w.fieldset(root_fields),
                    _SPEC_PSEUDO_ROOT))

    def visit(prim, path):
        base = '' if path == '/' else path
        fields = [
            w.field('typeName', w.token_rep(prim.type_name or 'Xform')),
            w.field('specifier', w._rep(_SPECIFIER, 0, inlined=True)),
        ]
        props = list(prim.attrs) + list(prim.time_attrs)
        if props:
            fields.append(w.field('properties', w.token_vector_rep(props)))
        if prim.children:
            fields.append(w.field('primChildren', w.token_vector_rep(
                list(prim.children))))
        w.specs.append((path_index[path], w.fieldset(fields), _SPEC_PRIM))
        for attr, (usd_type, value) in prim.attrs.items():
            afields = [
                w.field('typeName', w.token_rep(usd_type)),
                w.field('default', w.value_rep(usd_type, value)),
            ]
            w.specs.append((path_index[f'{base}.{attr}'],
                            w.fieldset(afields), _SPEC_ATTRIBUTE))
        for attr, (usd_type, samples) in prim.time_attrs.items():
            afields = [
                w.field('typeName', w.token_rep(usd_type)),
                w.field('timeSamples',
                        w.time_samples_rep(usd_type, samples)),
            ]
            w.specs.append((path_index[f'{base}.{attr}'],
                            w.fieldset(afields), _SPEC_ATTRIBUTE))
        for name, child in prim.children.items():
            visit(child, f'{base}/{name}')

    for name, child in stage.root.children.items():
        visit(child, f'/{name}')

    w.write_sections()
    out = file_path or stage.file_path
    with open(out, 'wb') as fh:
        fh.write(bytes(w.buf))
    return stage


def read_usdc(file_path, stage_cls):
    """Parses a usdc file into a ``stage_cls`` (``usd.Stage``) tree."""
    with open(file_path, 'rb') as fh:
        crate = _Crate(fh.read())
    stage = stage_cls(file_path)
    for path_idx, fset_idx, spec_ty in crate.specs:
        path = crate.paths[path_idx]
        fields = crate.spec_fields(fset_idx)
        if spec_ty == _SPEC_PSEUDO_ROOT:
            if 'defaultPrim' in fields:
                stage.default_prim = crate.value(fields['defaultPrim'])
            if 'upAxis' in fields:
                stage.up_axis = crate.value(fields['upAxis'])
        elif spec_ty == _SPEC_PRIM:
            type_name = 'Xform'
            if 'typeName' in fields:
                type_name = crate.value(fields['typeName'])
            stage.define_prim(path, type_name)
        elif spec_ty == _SPEC_ATTRIBUTE:
            prim_path, _, attr_name = path.rpartition('.')
            prim = stage.define_prim(prim_path, None)
            usd_type = 'token'
            if 'typeName' in fields:
                usd_type = crate.value(fields['typeName'])
            if 'default' in fields:
                prim.attrs[attr_name] = (usd_type,
                                         crate.value(fields['default']))
            if 'timeSamples' in fields:
                samples = crate.value(fields['timeSamples'])
                prim.time_attrs[attr_name] = (usd_type, samples)
    return stage
