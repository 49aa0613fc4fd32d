"""One name -> dtype resolver for serialized KV payloads.

The counterpart of ``dynamo_tpu/utils/dtypes.py``, without ``ml_dtypes``:
the disk tier (``engine/offload.py DiskKvStore``) writes ``str(np.dtype)``
names into its headers (``"bfloat16"``, ``"float8_e4m3fn"``, ``"int8"``,
``"float32"``...), letter for letter the reference's, so the two packages
read each other's entries. A name resolves to the ``torch`` dtype of the
payload and, for the two dtypes numpy lacks, the raw integer view a payload
of that dtype is read and written through (``uint16`` bits for bfloat16,
``uint8`` bytes for float8_e4m3fn).
"""

from __future__ import annotations

import torch

#: dtype name (``str(np.dtype)`` of the reference's arrays) -> torch dtype
TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8,
}

#: the dtypes numpy has no type for, and the integer type their payloads
#: are read through
_RAW_VIEWS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}

_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a serialized payload named ``name``; raises
    ``TypeError`` for a name the tiers do not carry (a malformed header)."""
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown KV payload dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name of ``dtype`` (what ``str(np.dtype)`` prints)."""
    return _NAMES[dtype]


def to_bytes(t: torch.Tensor) -> memoryview:
    """``t``'s elements in C order as a flat byte view (no copy of a
    contiguous CPU tensor): byte for byte what numpy's ``tobytes()`` gives
    for the same array in the reference."""
    t = t.detach().contiguous().cpu()
    return memoryview(t.view(torch.uint8).reshape(-1).numpy())


def from_bytes(buf, dtype: torch.dtype, count: int, offset: int,
               shape) -> torch.Tensor:
    """``count`` elements of ``dtype`` at byte ``offset`` of the writable
    buffer ``buf`` (a ``bytearray`` or a view of one), as a CPU tensor of
    ``shape`` that views it (no copy; the tensor keeps ``buf`` alive)."""
    raw = _RAW_VIEWS.get(dtype, dtype)
    t = torch.frombuffer(buf, dtype=raw, count=count, offset=offset)
    return t.view(dtype).reshape(list(shape))
