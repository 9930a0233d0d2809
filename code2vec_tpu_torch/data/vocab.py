"""Vocabulary: name <-> index maps with per-index frequency and subtokens.

Own copy of ``code2vec_tpu/data/vocab.py``, with the reference Vocab's
quirks (model/dataset.py:52-92): ``add`` ignores a name already present
(the first index wins), and ``freq`` counts first sightings only, so every
label's frequency is 1 and the reference's 1/freq class weights are
uniform. ``occurrences`` counts every sighting, for real frequency
weighting.
"""

from __future__ import annotations

from code2vec_tpu_torch.text import normalize_and_subtokenize


class Vocab:
    __slots__ = ("stoi", "itos", "itosubtokens", "freq", "occurrences")

    def __init__(self) -> None:
        self.stoi: dict[str, int] = {}
        self.itos: dict[int, str] = {}
        self.itosubtokens: dict[int, tuple[str, ...]] = {}
        self.freq: dict[int, int] = {}
        self.occurrences: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.stoi)

    def add(self, name: str, index: int | None = None,
            subtokens: tuple[str, ...] | None = None) -> int:
        """Insert ``name`` if unseen (at ``index``, else the next dense
        slot); return its index either way."""
        existing = self.stoi.get(name)
        if existing is not None:
            self.occurrences[existing] = self.occurrences.get(existing, 0) + 1
            return existing
        if index is None:
            index = len(self.stoi)
        self.stoi[name] = index
        self.itos[index] = name
        if subtokens is not None:
            self.itosubtokens[index] = tuple(subtokens)
        self.freq[index] = self.freq.get(index, 0) + 1
        self.occurrences[index] = self.occurrences.get(index, 0) + 1
        return index

    def add_label(self, raw_name: str) -> int:
        """Normalize + subtokenize a raw label and insert it
        (model/dataset_reader.py:94-102)."""
        normalized_lower, subtokens = normalize_and_subtokenize(raw_name)
        return self.add(normalized_lower, subtokens=subtokens)

    def freq_list(self) -> list[int]:
        """Frequencies indexed 0..len-1 (KeyError on an index gap, as the
        reference's would be)."""
        return [self.freq[i] for i in range(len(self.stoi))]

    def occurrence_list(self) -> list[int]:
        return [self.occurrences.get(i, 0) for i in range(len(self.stoi))]

    def to_state(self) -> list:
        """A JSON-serializable snapshot, the corpus cache's form (JAX's)."""
        return [[name, index,
                 list(self.itosubtokens[index]) if index in self.itosubtokens else None,
                 self.freq.get(index, 0), self.occurrences.get(index, 0)]
                for name, index in self.stoi.items()]

    @classmethod
    def from_state(cls, state: list) -> "Vocab":
        vocab = cls()
        for name, index, subtokens, freq, occurrences in state:
            vocab.stoi[name] = index
            vocab.itos[index] = name
            if subtokens is not None:
                vocab.itosubtokens[index] = tuple(subtokens)
            vocab.freq[index] = freq
            vocab.occurrences[index] = occurrences
        return vocab
