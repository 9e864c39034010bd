"""The safetensors file format, read and written with torch alone.

The port's replacement for the ``safetensors`` package (which the GPU
machine does not have). A file is:

- 8 bytes: the header's length ``N``, a little-endian u64;
- ``N`` bytes: a JSON object mapping each tensor's name to its
  ``{"dtype", "shape", "data_offsets": [begin, end]}``, plus an optional
  ``"__metadata__"`` object of strings; a writer may pad it with spaces;
- the data region: every tensor's raw little-endian bytes, at its offsets
  (relative to the region's start), packed with no hole and no overlap.

``read_header`` validates all of that before any tensor is read and
raises ``SafetensorsError`` naming the file and the tensor at fault.
``read_tensor`` reads ONE tensor's byte range into a fresh CPU buffer, so
the file is never resident as a whole, and the buffer is aligned by
torch's allocator whatever the tensor's offset in the file. ``save_file``
writes the format, one tensor at a time (each copied to the host just
before it is written), so a model on the card is staged one tensor at a
time too.

``stats`` counts what the reader stages on the host: bytes read, the
largest single read, and the peak of read buffers alive at once (a
buffer stays alive while any tensor viewing it does).
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
import weakref
from dataclasses import dataclass
from pathlib import Path

import torch

# Dtype code → torch dtype: every code an HF checkpoint uses.
DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_CODES = {v: k for k, v in DTYPES.items()}
# The header-length cap the reference implementation enforces.
MAX_HEADER_BYTES = 100_000_000


class SafetensorsError(ValueError):
    """A malformed safetensors file (the message names the file and, where
    one is at fault, the tensor)."""


@dataclass(frozen=True)
class TensorInfo:
    dtype: str
    shape: tuple[int, ...]
    begin: int  # offsets within the data region
    end: int


@dataclass(frozen=True)
class Header:
    tensors: dict[str, TensorInfo]
    metadata: dict[str, str] | None
    data_start: int  # file offset of the data region


@dataclass
class ReadStats:
    bytes_read: int = 0
    tensors_read: int = 0
    max_read_bytes: int = 0  # the largest single tensor read
    live_bytes: int = 0  # read buffers still referenced
    peak_live_bytes: int = 0


stats = ReadStats()


def reset_stats() -> None:
    global stats
    stats = ReadStats()


def _release(record: ReadStats, nbytes: int) -> None:
    record.live_bytes -= nbytes


def _check_little_endian() -> None:
    if sys.byteorder != "little":
        raise SafetensorsError("safetensors data is little-endian; this host is not")


def read_header(path: str | os.PathLike) -> Header:
    """Parse and validate ``path``'s header against the file's size."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError(
                f"{path}: {size} bytes, shorter than the 8-byte header length"
            )
        (n,) = struct.unpack("<Q", head)
        if n > size - 8 or n > MAX_HEADER_BYTES:
            raise SafetensorsError(
                f"{path}: header length {n} exceeds the file ({size} bytes)"
            )
        raw = f.read(n)
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{path}: header is not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    metadata = doc.pop("__metadata__", None)
    if metadata is not None and not (
        isinstance(metadata, dict)
        and all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items())
    ):
        raise SafetensorsError(f"{path}: __metadata__ is not an object of strings")
    data_size = size - 8 - n
    tensors = {name: _tensor_info(path, name, entry, data_size) for name, entry in doc.items()}
    cursor, prev = 0, None
    for name, info in sorted(tensors.items(), key=lambda kv: (kv[1].begin, kv[1].end)):
        if info.begin < cursor:
            raise SafetensorsError(
                f"{path}: tensor {name!r} at bytes [{info.begin}, {info.end}) "
                f"overlaps tensor {prev!r}, which ends at {cursor}"
            )
        if info.begin > cursor:
            raise SafetensorsError(
                f"{path}: tensor {name!r} starts at {info.begin}, leaving a "
                f"hole of {info.begin - cursor} bytes after byte {cursor}"
            )
        cursor, prev = info.end, name
    if cursor != data_size:
        raise SafetensorsError(
            f"{path}: the data region holds {data_size} bytes, its tensors "
            f"cover {cursor}"
        )
    return Header(tensors, metadata, 8 + n)


def _tensor_info(path: Path, name: str, entry, data_size: int) -> TensorInfo:
    where = f"{path}: tensor {name!r}"
    if not isinstance(entry, dict):
        raise SafetensorsError(f"{where}: entry is not an object")
    code = entry.get("dtype")
    if code not in DTYPES:
        raise SafetensorsError(f"{where}: unknown dtype {code!r}")
    shape = entry.get("shape")
    if not isinstance(shape, list) or not all(
        isinstance(d, int) and not isinstance(d, bool) and d >= 0 for d in shape
    ):
        raise SafetensorsError(f"{where}: bad shape {shape!r}")
    offsets = entry.get("data_offsets")
    if not (
        isinstance(offsets, list)
        and len(offsets) == 2
        and all(isinstance(o, int) and not isinstance(o, bool) for o in offsets)
        and 0 <= offsets[0] <= offsets[1]
    ):
        raise SafetensorsError(f"{where}: bad data_offsets {offsets!r}")
    begin, end = offsets
    if end > data_size:
        raise SafetensorsError(
            f"{where}: data_offsets [{begin}, {end}] lie outside the data "
            f"region of {data_size} bytes"
        )
    need = math.prod(shape) * DTYPES[code].itemsize
    if need != end - begin:
        raise SafetensorsError(
            f"{where}: shape {shape} of {code} needs {need} bytes, its "
            f"data_offsets span {end - begin}"
        )
    return TensorInfo(code, tuple(shape), begin, end)


def read_tensor(
    path: str | os.PathLike, name: str, header: Header | None = None
) -> torch.Tensor:
    """Tensor ``name`` of ``path`` as a CPU tensor, read from its own byte
    range into a fresh buffer (pass ``header`` to skip re-parsing it)."""
    _check_little_endian()
    header = header or read_header(path)
    info = header.tensors.get(name)
    if info is None:
        raise KeyError(f"{path}: no tensor named {name!r}")
    dtype = DTYPES[info.dtype]
    n = info.end - info.begin
    if n == 0:
        return torch.empty(info.shape, dtype=dtype)
    buf = torch.empty(n, dtype=torch.uint8)
    view = memoryview(buf.numpy())
    with open(path, "rb") as f:
        f.seek(header.data_start + info.begin)
        got = 0
        while got < n:
            k = f.readinto(view[got:])
            if not k:
                raise SafetensorsError(
                    f"{path}: tensor {name!r}: the file ended after {got} of its {n} bytes"
                )
            got += k
    out = buf.view(dtype).reshape(info.shape)
    record = stats
    record.bytes_read += n
    record.tensors_read += 1
    record.max_read_bytes = max(record.max_read_bytes, n)
    record.live_bytes += n
    record.peak_live_bytes = max(record.peak_live_bytes, record.live_bytes)
    weakref.finalize(out, _release, record, n)
    return out


def save_file(
    tensors: dict[str, torch.Tensor],
    path: str | os.PathLike,
    metadata: dict[str, str] | None = None,
) -> None:
    """Write ``tensors`` (on any device) to ``path`` in the safetensors
    format, in the dict's order, each copied to the host just before it is
    written."""
    _check_little_endian()
    doc: dict = {}
    if metadata is not None:
        doc["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise SafetensorsError(f"{path}: tensor {name!r}: no dtype code for {t.dtype}")
        n = t.numel() * t.element_size()
        doc[name] = {
            "dtype": _CODES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + n],
        }
        offset += n
    raw = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().to("cpu").reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
