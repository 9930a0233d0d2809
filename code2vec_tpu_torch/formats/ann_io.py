"""Binary memory-mapped ANN index container (IVF-PQ).

Own copy of ``code2vec_tpu/formats/ann_io.py``: a container written by
either package reads back in the other with equal arrays, meta and labels.
Layout: magic + uint64 header length + JSON header (``{"version",
"meta", "sections": {name: [offset, dtype, shape]}}``, keys sorted) +
16-byte-aligned raw little-endian sections, written atomically (tmp +
``os.replace``). The reader returns views into one shared read-only
``np.memmap``: the re-rank ``rows`` and the cell-major codes cost no host
memory until touched. Header ``meta`` carries the index geometry (n, dim,
n_list, m, capacity, defaults).
"""

from __future__ import annotations

import json
import os

import numpy as np

ANN_MAGIC = b"C2VANN1\n"
_ALIGN = 16
_VERSION = 1

_DTYPES = {"float32": 4, "int64": 8, "int32": 4, "uint8": 1}


def _aligned(offset: int) -> int:
    return (offset + _ALIGN - 1) // _ALIGN * _ALIGN


def is_ann_index(path: str | os.PathLike) -> bool:
    """Magic sniff."""
    try:
        with open(path, "rb") as f:
            return f.read(len(ANN_MAGIC)) == ANN_MAGIC
    except OSError:
        return False


def write_ann_container(
    path: str | os.PathLike,
    arrays: dict[str, np.ndarray],
    meta: dict,
) -> None:
    """Write ``arrays`` + ``meta`` as one container. Section order follows
    the dict order, so put the hot small sections first and the big
    mmap-heavy ones (rows) last if locality matters."""
    path = os.fspath(path)
    sections: dict[str, tuple[np.ndarray, str, tuple[int, ...]]] = {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        dtype = arr.dtype.name
        if dtype not in _DTYPES:
            raise ValueError(
                f"section {name!r}: unsupported dtype {dtype!r} "
                f"(supported: {sorted(_DTYPES)})"
            )
        sections[name] = (arr, dtype, tuple(int(d) for d in arr.shape))

    def render(table: dict) -> bytes:
        return json.dumps(
            {"version": _VERSION, "meta": meta, "sections": table},
            sort_keys=True,
        ).encode("utf-8")

    # fix-point over the header length (corpus_io's layout discipline:
    # offsets widen digits; re-layout until the serialization is stable)
    header_len = len(
        render({n: [0, d, list(s)] for n, (_, d, s) in sections.items()})
    )
    for _ in range(4):
        offset = _aligned(16 + header_len)
        table = {}
        for name, (arr, dtype, shape) in sections.items():
            table[name] = [offset, dtype, list(shape)]
            offset = _aligned(offset + arr.size * _DTYPES[dtype])
        header = render(table)
        if len(header) == header_len:
            break
        header_len = len(header)
    else:
        raise RuntimeError("ann container header layout did not converge")

    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as out:
        out.write(ANN_MAGIC)
        out.write(np.uint64(header_len).tobytes())
        out.write(header)
        for name, (arr, dtype, _) in sections.items():
            off = table[name][0]
            out.write(b"\0" * (off - out.tell()))
            out.write(arr.tobytes())
    os.replace(tmp, path)


def read_ann_container(
    path: str | os.PathLike,
) -> tuple[dict[str, np.ndarray], dict]:
    """Open a container: ``(arrays, meta)``. Every array is a read-only
    view into one shared ``np.memmap`` — copy what you want resident."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        magic = f.read(len(ANN_MAGIC))
        if magic != ANN_MAGIC:
            raise ValueError(f"{path}: not an ANN index container")
        header_len = int(np.frombuffer(f.read(8), np.uint64)[0])
        payload = json.loads(f.read(header_len).decode("utf-8"))
    if payload.get("version") != _VERSION:
        raise ValueError(
            f"{path}: ann container version {payload.get('version')!r} "
            f"(this build reads {_VERSION})"
        )
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    arrays: dict[str, np.ndarray] = {}
    for name, (offset, dtype, shape) in payload["sections"].items():
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * _DTYPES[dtype]
        view = mm[offset : offset + nbytes].view(dtype)
        arrays[name] = view.reshape(tuple(shape))
    return arrays, payload["meta"]
