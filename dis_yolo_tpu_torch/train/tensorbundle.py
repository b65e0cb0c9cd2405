"""Native TF1 TensorBundle (``.ckpt``) reader — no TensorFlow required (a
copy of ``dis_yolo_tpu/train/tensorbundle.py``; pure numpy).

The reference's transfer-learning workflow starts from the published
pretrained ``yolov3_3class_coco.ckpt`` (the reference's
``pretrained_weights/pretrained weight.txt``), restored selectively into
the backbone + detection heads at the reference's
``train_yolo3_mask.py:104-107``.  A TF1 ``saver.save``
checkpoint is a *TensorBundle*: two files per prefix

  ``<prefix>.index``                 an SSTable (LevelDB table format) whose
                                     keys are tensor names and whose values
                                     are serialized BundleEntryProto records
                                     (dtype, shape, shard, offset, size,
                                     crc32c); the empty key holds the
                                     BundleHeaderProto (num_shards, endian)
  ``<prefix>.data-NNNNN-of-MMMMM``   raw little-endian tensor bytes, each
                                     tensor a contiguous [offset, offset+size)
                                     span of its shard

This module parses both in pure numpy + stdlib, closing the last external
tool dependency of the conversion path (``train/checkpoint.py``'s
``convert_tf1_checkpoint`` previously required TensorFlow).

Format notes (verified against the LevelDB ``table_format`` spec and TF's
``tensor_bundle.cc``):

* TF's BundleWriter builds the index with ``kNoCompression`` and the
  default restart policy, so blocks are plain prefix-compressed key runs:
  ``[shared varint32][unshared varint32][value_len varint32][key suffix]
  [value]``, followed by a uint32 restart-offset array and its count.
* Every block is trailed by 1 compression-type byte + 4-byte masked
  crc32c.  The footer (last 48 bytes of the file) holds the metaindex and
  index BlockHandles (varint64 offset/size pairs), zero padding, and the
  LevelDB table magic ``0xdb4775248b80fb57``.
* BundleEntryProto wire fields: 1 dtype (varint), 2 shape (msg; repeated
  Dim msg field 2, whose field 1 is the dim size varint), 3 shard_id
  (varint), 4 offset (varint), 5 size (varint), 6 crc32c (fixed32),
  7 slices (msg, partitioned variables only — rejected here).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow/core/framework/types.proto enum -> numpy dtype (little-endian;
# BundleHeaderProto.endianness is checked before use)
_DTYPES = {
    1: np.dtype("<f4"),    # DT_FLOAT
    2: np.dtype("<f8"),    # DT_DOUBLE
    3: np.dtype("<i4"),    # DT_INT32
    4: np.dtype("<u1"),    # DT_UINT8
    5: np.dtype("<i2"),    # DT_INT16
    6: np.dtype("<i1"),    # DT_INT8
    9: np.dtype("<i8"),    # DT_INT64
    10: np.dtype("?"),     # DT_BOOL
    14: np.dtype("<u2"),   # DT_BFLOAT16 (returned as raw uint16 bit pattern)
    17: np.dtype("<u2"),   # DT_UINT16
    19: np.dtype("<f2"),   # DT_HALF
    22: np.dtype("<u4"),   # DT_UINT32
    23: np.dtype("<u8"),   # DT_UINT64
}


# ---------------------------------------------------------------------------
# varint / protobuf wire format
# ---------------------------------------------------------------------------

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """LEB128 varint at ``pos`` -> (value, next_pos)."""
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt file?)")


def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message.

    varint fields yield ints; length-delimited yield bytes; fixed32/64
    yield ints.  Groups (wire types 3/4) are not used by TF protos.
    """
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val, pos = _varint(buf, pos)
        elif wire == 1:                     # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:                     # length-delimited
            n, pos = _varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:                     # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> List[int]:
    """TensorShapeProto -> dim sizes (field 2 = repeated Dim{1: size})."""
    dims = []
    for field, _, val in _proto_fields(buf):
        if field == 2:                      # TensorShapeProto.Dim
            size = 0
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    # int64 varint; negative (unknown) dims would wrap
                    size = v2 - (1 << 64) if v2 >> 63 else v2
            dims.append(size)
        elif field == 3 and val:            # unknown_rank
            raise ValueError("tensor with unknown rank in bundle")
    return dims


class BundleEntry:
    """Parsed BundleEntryProto (one tensor's locator)."""

    __slots__ = ("dtype_code", "shape", "shard_id", "offset", "size", "crc32c")

    def __init__(self, buf: bytes):
        self.dtype_code = 0
        self.shape: List[int] = []
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0
        for field, _, val in _proto_fields(buf):
            if field == 1:
                self.dtype_code = val
            elif field == 2:
                self.shape = _parse_shape(val)
            elif field == 3:
                self.shard_id = val
            elif field == 4:
                self.offset = val
            elif field == 5:
                self.size = val
            elif field == 6:
                self.crc32c = val
            elif field == 7:
                raise ValueError(
                    "sliced (partitioned-variable) bundle entries are not "
                    "supported — re-save the checkpoint unpartitioned")


# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — used to verify index blocks and, optionally, tensors
# ---------------------------------------------------------------------------

def _crc32c_table() -> np.ndarray:
    poly = 0x82F63B78                       # reflected 0x1EDC6F41
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """Bytewise table-driven crc32c; fine for index blocks (KBs), slow for
    multi-MB tensors — tensor verification is therefore opt-in."""
    crc = crc ^ 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def crc32c_masked(data: bytes) -> int:
    """LevelDB/TF's masked crc: rot15 + magic (block trailers, proto crcs)."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# SSTable (LevelDB table) reading
# ---------------------------------------------------------------------------

def _read_block(data: bytes, offset: int, size: int,
                verify: bool = True) -> bytes:
    """Block contents at a BlockHandle; checks type byte + masked crc32c."""
    if offset + size + 5 > len(data):
        raise ValueError("block handle out of range (truncated .index?)")
    contents = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype != 0:
        raise ValueError(
            f"compressed table block (type {ctype}); TF's BundleWriter "
            "writes kNoCompression — not a TensorBundle index?")
    if verify:
        stored = struct.unpack_from("<I", data, offset + size + 1)[0]
        if crc32c_masked(data[offset:offset + size + 1]) != stored:
            raise ValueError("index block crc32c mismatch (corrupt .index)")
    return contents


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) from a prefix-compressed table block."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * n_restarts
    if data_end < 0:
        raise ValueError("bad restart array in table block")
    pos, key = 0, b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        value = block[pos:pos + vlen]
        pos += vlen
        yield key, value


def _table_entries(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """All (key, value) pairs of an SSTable file, in key order."""
    if len(data) < 48:
        raise ValueError("file too small to be an SSTable (.index)")
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(
            "bad table magic — not a TensorBundle .index file (a single-"
            "file V1 checkpoint? re-save with TF1's default V2 saver)")
    pos = 0
    _, pos = _varint(footer, pos)           # metaindex handle (unused)
    _, pos = _varint(footer, pos)
    idx_off, pos = _varint(footer, pos)     # index block handle
    idx_size, pos = _varint(footer, pos)
    for _, handle in _block_entries(_read_block(data, idx_off, idx_size)):
        hpos = 0
        boff, hpos = _varint(handle, hpos)
        bsize, hpos = _varint(handle, hpos)
        yield from _block_entries(_read_block(data, boff, bsize))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def read_tensor_bundle(prefix: str,
                       verify_tensors: bool = False
                       ) -> Dict[str, np.ndarray]:
    """Read a TF1 V2 checkpoint (``saver.save`` TensorBundle) -> ndarrays.

    ``prefix`` is the checkpoint path as TF names it, e.g.
    ``.../yolov3_3class_coco.ckpt`` (the files on disk are
    ``<prefix>.index`` + ``<prefix>.data-00000-of-NNNNN``).

    ``verify_tensors=True`` additionally checks each tensor's stored
    crc32c (bytewise Python — slow on multi-hundred-MB checkpoints).

    bfloat16 tensors are returned as uint16 bit patterns (numpy has no
    native bfloat16); all other dtypes map to their numpy equivalents.
    """
    index_path = prefix + ".index"
    if not os.path.isfile(index_path):
        raise FileNotFoundError(
            f"{index_path} not found — pass the checkpoint PREFIX "
            "(e.g. model.ckpt), not one of its component files")
    with open(index_path, "rb") as f:
        index_data = f.read()

    num_shards, big_endian = 1, False
    entries: Dict[str, BundleEntry] = {}
    for key, value in _table_entries(index_data):
        if key == b"":
            for field, _, val in _proto_fields(value):  # BundleHeaderProto
                if field == 1:
                    num_shards = val
                elif field == 2 and val == 1:
                    big_endian = True
        else:
            entries[key.decode("utf-8")] = BundleEntry(value)
    if big_endian:
        raise ValueError("big-endian TensorBundle not supported")

    shards: Dict[int, np.memmap] = {}

    def shard(i: int) -> np.memmap:
        if i not in shards:
            path = f"{prefix}.data-{i:05d}-of-{num_shards:05d}"
            shards[i] = np.memmap(path, dtype=np.uint8, mode="r")
        return shards[i]

    out: Dict[str, np.ndarray] = {}
    for name, e in entries.items():
        if e.dtype_code not in _DTYPES:
            raise ValueError(f"{name}: unsupported dtype enum {e.dtype_code} "
                             "(string/resource tensors are not weights)")
        dtype = _DTYPES[e.dtype_code]
        raw = bytes(shard(e.shard_id)[e.offset:e.offset + e.size])
        if len(raw) != e.size:
            raise ValueError(f"{name}: data shard truncated")
        if verify_tensors and e.crc32c:
            # entry crc is the *masked* crc32c of the payload bytes
            if crc32c_masked(raw) != e.crc32c:
                raise ValueError(f"{name}: tensor crc32c mismatch")
        n = int(np.prod(e.shape, dtype=np.int64)) if e.shape else 1
        if n * dtype.itemsize != e.size:
            raise ValueError(
                f"{name}: {e.size} bytes != shape {e.shape} x {dtype}")
        out[name] = np.frombuffer(raw, dtype=dtype).reshape(e.shape)
    return out
