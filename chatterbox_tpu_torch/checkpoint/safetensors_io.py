"""Self-contained safetensors reader/writer (numpy only, no Rust package).

The port's own copy of the JAX package's reader: an 8-byte LE header length,
a JSON header mapping names to {dtype, shape, data_offsets}, then raw
little-endian tensor bytes. BF16 payloads are returned as uint16 arrays
flagged in the second return value; ``weights.py`` views them as
``torch.bfloat16`` without a float round trip.
"""

import json
import struct

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # raw bits; the caller views them as bfloat16
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}

_TO_ST_DTYPE = {
    np.dtype(np.float64): "F64",
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.bool_): "BOOL",
}


def load_safetensors(path):
    """Read a .safetensors file -> (dict[name, np.ndarray], set of BF16 names).

    BF16 tensors come back as their uint16 bit patterns."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
        data = f.read()
    out, bf16 = {}, set()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"])
        if meta["dtype"] == "BF16":
            bf16.add(name)
    return out, bf16


def save_safetensors(tensors, path, metadata=None):
    """Write dict[name, np.ndarray] to a .safetensors file."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _TO_ST_DTYPE:
            arr = arr.astype(np.float32)
        header[name] = {
            "dtype": _TO_ST_DTYPE[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + arr.nbytes],
        }
        offset += arr.nbytes
        blobs.append(arr.tobytes())
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
