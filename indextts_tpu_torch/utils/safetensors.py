"""A reader of the safetensors format, for the checkpoint loader's hf/ files.

The format: an 8-byte little-endian header length, a JSON header that maps
each tensor's name to its `dtype`, `shape` and `data_offsets` (begin, end
in the byte buffer after the header), with an optional `__metadata__`
entry, then the raw little-endian bytes. The JAX package reads these files
with the `safetensors` package; the port reads them itself, so that a
machine without that package loads a checkpoint directory all the same.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU, in its stored dtype
    (what `safetensors.torch.load_file` gives)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            begin, end = info["data_offsets"]
            t = torch.empty(info["shape"], dtype=DTYPES[info["dtype"]])
            # a byte view of the tensor: torch.bfloat16 has no numpy dtype
            buf = t.reshape(-1).view(torch.uint8).numpy()
            f.seek(8 + n + begin)
            if buf.nbytes != end - begin or f.readinto(buf) != buf.nbytes:
                raise ValueError(f"{path}: tensor {name!r} of {info['dtype']} {info['shape']} "
                                 f"does not fill bytes [{begin}, {end})")
            out[name] = t
    return out
