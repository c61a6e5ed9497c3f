"""A reader and a writer of the safetensors format: the checkpoint loader's
hf/ files and its converted-weights cache (runtime/loader.py).

The format: an 8-byte little-endian header length, a JSON header that maps
each tensor's name to its `dtype`, `shape` and `data_offsets` (begin, end
in the byte buffer after the header), with an optional `__metadata__`
entry (str to str), then the raw little-endian bytes. The JAX package reads
these files with the `safetensors` package; the port reads and writes them
itself, so that a machine without that package loads a checkpoint
directory all the same.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
CODES = {dtype: code for code, dtype in DTYPES.items()}


def load_file_with_metadata(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """(every tensor of a .safetensors file, on the CPU, in its stored dtype;
    the header's `__metadata__`, {} where there is none)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        metadata = header.pop("__metadata__", None) or {}
        for name, info in header.items():
            begin, end = info["data_offsets"]
            t = torch.empty(info["shape"], dtype=DTYPES[info["dtype"]])
            # a byte view of the tensor: torch.bfloat16 has no numpy dtype
            buf = t.reshape(-1).view(torch.uint8).numpy()
            f.seek(8 + n + begin)
            if buf.nbytes != end - begin or f.readinto(buf) != buf.nbytes:
                raise ValueError(f"{path}: tensor {name!r} of {info['dtype']} {info['shape']} "
                                 f"does not fill bytes [{begin}, {end})")
            out[name] = t
    return out, metadata


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU, in its stored dtype
    (what `safetensors.torch.load_file` gives)."""
    return load_file_with_metadata(path)[0]


def save_file(tensors: Mapping[str, torch.Tensor], path,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device; copied to the host) to `path`: the JSON
    header padded with spaces to 8 bytes, then the raw bytes in the
    header's order (what `safetensors.torch.save_file` writes)."""
    header = {"__metadata__": dict(metadata)} if metadata else {}
    views, offset = [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        views.append(t.reshape(-1).view(torch.uint8).numpy())
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for v in views:
            f.write(memoryview(v))
