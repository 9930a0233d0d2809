"""``params.txt``: extraction stats as ``key:value`` lines.

Own copy of ``code2vec_tpu/formats/params_io.py`` (written by the reference
extractor, create_path_contexts.ipynb cell11), e.g. ``max_length:8``,
``terminal_vocab_count:360631``, ``method_count:605945``.
"""

from __future__ import annotations

import os


def read_params(path: str | os.PathLike) -> dict[str, str]:
    params: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, value = line.split(":", 1)
            params[key] = value
    return params


def write_params(path: str | os.PathLike, params: dict[str, object]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for key, value in params.items():
            f.write(f"{key}:{value}\n")
