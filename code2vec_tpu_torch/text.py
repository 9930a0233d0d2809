"""Method-name normalization and subtokenization.

Own copy of ``code2vec_tpu/text.py``. These rules define label identity
for training and the subtoken metrics (reference: model/dataset.py:55-56,
86-92), so they must match the JAX package's character for character.
"""

from __future__ import annotations

import re
from functools import lru_cache

# stripped before subtokenization: "get_value_2" -> "getvalue"
_REDUNDANT_SYMBOL_CHARS = re.compile(r"[_0-9]+")

# camelCase splitter, used with re.split so the capture groups become the
# tokens; None / '' pieces are dropped
_METHOD_SUBTOKEN_SEPARATOR = re.compile(r"([a-z]+)([A-Z][a-z]+)|([A-Z][a-z]+)")


def normalize_method_name(name: str) -> str:
    """Strip underscores and digits (reference: model/dataset.py:86-88)."""
    return _REDUNDANT_SYMBOL_CHARS.sub("", name)


def subtokenize(normalized_name: str) -> list[str]:
    """Lowercase camelCase pieces of a normalized name (reference:
    model/dataset.py:90-92)."""
    return [
        piece.lower()
        for piece in _METHOD_SUBTOKEN_SEPARATOR.split(normalized_name)
        if piece is not None and piece != ""
    ]


@lru_cache(maxsize=1 << 20)
def normalize_and_subtokenize(name: str) -> tuple[str, tuple[str, ...]]:
    """``(normalized lowercase name, subtokens)`` of a raw method or
    variable name (reference: model/dataset_reader.py:97-100)."""
    normalized = normalize_method_name(name)
    return normalized.lower(), tuple(subtokenize(normalized))
