"""Reference binary format interop: LoDTensor streams + ProgramDesc
(JAX: fluid/paddle_format.py, whose codec this is).

Reference serialization re-implemented from first principles against:
- framework/lod_tensor.cc:219 SerializeToStream — u32 tensor version,
  u64 lod level count, per level (u64 byte size + size_t offsets),
  then the Tensor stream;
- framework/tensor_util.cc TensorToStream — u32 version, i32 protobuf
  size, VarType.TensorDesc{data_type, dims}, raw data bytes;
- operators/save_op.cc / save_combine_op.h — one stream per file, or
  streams concatenated in input order;
- framework/framework.proto — ProgramDesc/BlockDesc/VarDesc/OpDesc
  wire schema (proto2).

A minimal protobuf wire codec lives here (the framework has no
protobuf dependency; the messages involved are small and stable), so
`load_persistables` on a directory written by reference fluid
populates the scope directly, and `load_inference_model` parses the
binary `__model__` ProgramDesc into a framework.Program.  Arrays are
numpy on both sides of the codec: io.py moves them to and from the
scope's tensors.
"""

import struct

import numpy as np

# --------------------------------------------------------------------------
# protobuf wire codec (proto2, the subset framework.proto uses)
# --------------------------------------------------------------------------


def _read_uvarint(data, pos):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError('malformed varint')


def _emit_uvarint(n):
    n &= (1 << 64) - 1  # negative int64 -> 10-byte two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed64(n):
    return n - (1 << 64) if n >= (1 << 63) else n


def parse_message(data):
    """bytes -> {field_number: [value, ...]} where value is int (wire
    types 0/1/5 — fixed ones kept as raw int bits) or bytes (type 2)."""
    fields = {}
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_uvarint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_uvarint(data, pos)
        elif wt == 1:
            val = int.from_bytes(data[pos:pos + 8], 'little')
            pos += 8
        elif wt == 5:
            val = int.from_bytes(data[pos:pos + 4], 'little')
            pos += 4
        elif wt == 2:
            ln, pos = _read_uvarint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        else:
            raise ValueError('unsupported wire type %d' % wt)
        fields.setdefault(field, []).append(val)
    return fields


def _field(fields, num, default=None):
    vals = fields.get(num)
    return vals[-1] if vals else default


def _emit_field(field, wt, payload):
    out = _emit_uvarint((field << 3) | wt)
    if wt == 0:
        return out + _emit_uvarint(payload)
    if wt == 2:
        return out + _emit_uvarint(len(payload)) + payload
    if wt == 5:
        return out + payload
    raise ValueError(wt)


# --------------------------------------------------------------------------
# dtypes (framework.proto VarType.Type <-> numpy)
# --------------------------------------------------------------------------

PROTO_TO_NP = {0: 'bool', 1: 'int16', 2: 'int32', 3: 'int64',
               4: 'float16', 5: 'float32', 6: 'float64',
               19: 'uint64', 20: 'uint8', 21: 'int8'}
NP_TO_PROTO = {v: k for k, v in PROTO_TO_NP.items()}

VARTYPE_NAMES = {7: 'LOD_TENSOR', 8: 'SELECTED_ROWS',
                 9: 'FEED_MINIBATCH', 10: 'FETCH_LIST',
                 11: 'STEP_SCOPES', 12: 'LOD_RANK_TABLE',
                 13: 'LOD_TENSOR_ARRAY', 14: 'PLACE_LIST',
                 15: 'READER', 17: 'RAW'}

# --------------------------------------------------------------------------
# LoDTensor streams (lod_tensor.cc:219 + tensor_util.cc TensorToStream)
# --------------------------------------------------------------------------


def _encode_tensor_desc(np_dtype, dims):
    out = _emit_field(1, 0, NP_TO_PROTO[str(np_dtype)])
    for d in dims:
        out += _emit_field(2, 0, int(d))
    return out


def _decode_tensor_desc(data):
    fields = parse_message(data)
    dtype = PROTO_TO_NP[_field(fields, 1)]
    dims = [_signed64(v) for v in fields.get(2, [])]
    return dtype, dims


def write_lod_tensor(f, arr, lod=()):
    """Serialize one tensor exactly as SerializeToStream does."""
    arr = np.ascontiguousarray(arr)
    if str(arr.dtype) not in NP_TO_PROTO:
        raise ValueError('dtype %s has no reference VarType' % arr.dtype)
    f.write(struct.pack('<I', 0))            # LoDTensor version
    f.write(struct.pack('<Q', len(lod)))     # lod level count
    for level in lod:
        level = np.ascontiguousarray(level, np.uint64)
        f.write(struct.pack('<Q', level.nbytes))
        f.write(level.tobytes())
    f.write(struct.pack('<I', 0))            # Tensor version
    desc = _encode_tensor_desc(arr.dtype, arr.shape)
    f.write(struct.pack('<i', len(desc)))
    f.write(desc)
    f.write(arr.tobytes())


def read_lod_tensor(f):
    """Inverse of write_lod_tensor; reads ONE record so combined files
    (save_combine) parse by repeated calls."""
    head = f.read(4)
    if len(head) < 4:
        raise EOFError('end of tensor stream')
    (ver,) = struct.unpack('<I', head)
    if ver != 0:
        raise ValueError('unsupported LoDTensor version %d' % ver)
    (lod_levels,) = struct.unpack('<Q', f.read(8))
    if lod_levels > 64:
        raise ValueError('implausible lod level count %d' % lod_levels)
    lod = []
    for _ in range(lod_levels):
        (nbytes,) = struct.unpack('<Q', f.read(8))
        lod.append(np.frombuffer(f.read(nbytes), np.uint64).copy())
    (tver,) = struct.unpack('<I', f.read(4))
    if tver != 0:
        raise ValueError('unsupported Tensor version %d' % tver)
    (desc_len,) = struct.unpack('<i', f.read(4))
    dtype, dims = _decode_tensor_desc(f.read(desc_len))
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(f.read(count * np.dtype(dtype).itemsize),
                        dtype).copy().reshape(dims)
    return arr, lod


def save_tensors(path, named_arrays):
    """save_combine layout: records concatenated in order.  For the
    one-file-per-var layout call with a single pair per file."""
    with open(path, 'wb') as f:
        for _, arr in named_arrays:
            write_lod_tensor(f, arr)


def load_tensors(path, count=None):
    """Read `count` records (None = until EOF)."""
    out = []
    with open(path, 'rb') as f:
        while count is None or len(out) < count:
            try:
                arr, lod = read_lod_tensor(f)
            except EOFError:
                if count is not None:
                    raise
                break
            out.append((arr, lod))
    return out


def looks_like_lod_tensor_file(path):
    """Sniff the reference format: u32 0 + u64 lod_levels<=64."""
    try:
        with open(path, 'rb') as f:
            head = f.read(12)
        if len(head) < 12:
            return False
        ver, levels = struct.unpack('<IQ', head)
        return ver == 0 and levels <= 64
    except OSError:
        return False


# --------------------------------------------------------------------------
# ProgramDesc -> framework.Program (framework.proto:163-215)
# --------------------------------------------------------------------------

_ATTR_DECODERS = {
    0: lambda f: _signed64(_field(f, 3, 0)),                   # INT
    1: lambda f: struct.unpack('<f', struct.pack(
        '<I', _field(f, 4, 0)))[0],                            # FLOAT
    2: lambda f: _field(f, 5, b'').decode('utf-8'),            # STRING
    3: lambda f: [_signed64(v) for v in f.get(6, [])],         # INTS
    4: lambda f: [struct.unpack('<f', struct.pack('<I', v))[0]
                  for v in f.get(7, [])],                      # FLOATS
    5: lambda f: [v.decode('utf-8') for v in f.get(8, [])],    # STRINGS
    6: lambda f: bool(_field(f, 10, 0)),                       # BOOLEAN
    7: lambda f: [bool(v) for v in f.get(11, [])],             # BOOLEANS
    8: lambda f: _signed64(_field(f, 12, 0)),                  # BLOCK
    9: lambda f: _signed64(_field(f, 13, 0)),                  # LONG
    10: lambda f: [_signed64(v) for v in f.get(14, [])],       # BLOCKS
    11: lambda f: [_signed64(v) for v in f.get(15, [])],       # LONGS
}


def _decode_attr(data):
    fields = parse_message(data)
    name = _field(fields, 1, b'').decode('utf-8')
    atype = _field(fields, 2, 0)
    dec = _ATTR_DECODERS.get(atype)
    if dec is None:
        raise ValueError('unsupported attr type %d for %r'
                         % (atype, name))
    return name, dec(fields)


def _decode_op_var(data):
    fields = parse_message(data)
    slot = _field(fields, 1, b'').decode('utf-8')
    args = [v.decode('utf-8') for v in fields.get(2, [])]
    return slot, args


def _decode_var_desc(data):
    fields = parse_message(data)
    name = _field(fields, 1, b'').decode('utf-8')
    vt = parse_message(_field(fields, 2, b''))
    kind = VARTYPE_NAMES.get(_field(vt, 1, 7), 'LOD_TENSOR')
    persistable = bool(_field(fields, 3, 0))
    dtype, dims, lod_level = 'float32', [], 0
    lt = _field(vt, 3)  # LoDTensorDesc
    if lt is not None:
        ltf = parse_message(lt)
        td = _field(ltf, 1)
        if td is not None:
            dtype, dims = _decode_tensor_desc(td)
        lod_level = _field(ltf, 2, 0)
    elif _field(vt, 2) is not None:  # selected_rows TensorDesc
        dtype, dims = _decode_tensor_desc(_field(vt, 2))
    return dict(name=name, shape=list(dims), dtype=dtype,
                lod_level=lod_level, persistable=persistable,
                stop_gradient=False, type=kind, is_data=False,
                is_parameter=False)


def _decode_op_desc(data):
    fields = parse_message(data)
    op_type = _field(fields, 3, b'').decode('utf-8')
    inputs = dict(_decode_op_var(v) for v in fields.get(1, []))
    outputs = dict(_decode_op_var(v) for v in fields.get(2, []))
    attrs = dict(_decode_attr(v) for v in fields.get(4, []))
    return dict(type=op_type, inputs=inputs, outputs=outputs,
                attrs=attrs)


def _decode_block_desc(data):
    fields = parse_message(data)
    return dict(
        idx=_field(fields, 1, 0),
        parent_idx=_signed64(_field(fields, 2, 0)) if
        _field(fields, 2) is not None else -1,
        vars=[_decode_var_desc(v) for v in fields.get(3, [])],
        ops=[_decode_op_desc(v) for v in fields.get(4, [])])


def parse_program_desc(data):
    """Binary ProgramDesc -> framework.Program."""
    from . import framework
    fields = parse_message(data)
    blocks = [_decode_block_desc(b) for b in fields.get(1, [])]
    return framework.Program.from_dict(
        {'random_seed': 0, 'blocks': blocks})


def strip_feed_fetch(program):
    """Reference load_inference_model semantics: remove the feed/fetch
    ops the saver appended, returning (program, feed_names,
    fetch_names) with targets in feed/fetch `col` order."""
    block = program.global_block()
    feeds, fetches = {}, {}
    kept = []
    for op in block.ops:
        if op.type == 'feed':
            feeds[op.attrs.get('col', len(feeds))] = \
                op.output_arg_names[0]
        elif op.type == 'fetch':
            fetches[op.attrs.get('col', len(fetches))] = \
                op.input_arg_names[0]
        else:
            kept.append(op)
    block.ops = kept
    for aux in ('feed', 'fetch'):
        block.vars.pop(aux, None)
    feed_names = [feeds[k] for k in sorted(feeds)]
    fetch_names = [fetches[k] for k in sorted(fetches)]
    for n in feed_names:
        v = block.vars.get(n)
        if v is not None:
            v.is_data = True
    return program, feed_names, fetch_names
