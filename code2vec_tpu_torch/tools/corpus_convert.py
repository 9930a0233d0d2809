"""Convert a text corpus to the memory-mapped CSR container, and back.

Counterpart of ``tools/corpus_convert.py``, the same arguments and the
same summary line. The container (``formats/corpus_io.py``, JAX's bytes)
is the out-of-core corpus format: training gathers its context sections
through mmap views (``--corpus_format csr``), so a corpus larger than host
RAM feeds in bounded RSS. The conversion streams: its RSS is O(items +
strings), never O(contexts). Start and end ids are stored shifted by
``@question``'s +1 and the reverse conversion subtracts it, so::

    python -m code2vec_tpu_torch.tools.corpus_convert corpus.txt corpus.csr
    python -m code2vec_tpu_torch.tools.corpus_convert --to-text corpus.csr roundtrip.txt

gives a ``roundtrip.txt`` byte-identical to a ``corpus.txt`` written by
``formats.corpus_io.write_corpus`` (the synthetic generator's and the
extractor's). Host only: it touches no device. The container's footer
holds the context-count histogram (``tools/corpus_stats.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from code2vec_tpu_torch import QUESTION_TOKEN_INDEX
from code2vec_tpu_torch.formats.corpus_io import (
    CsrCorpusWriter,
    is_csr_corpus,
    iter_corpus_records,
    open_corpus_csr,
    write_corpus_record,
)


def text_to_csr(src: str, dst: str, shift: int = QUESTION_TOKEN_INDEX) -> int:
    """``src`` (a text corpus) streamed into ``dst`` (a CSR container);
    returns the record count."""
    n = 0
    with CsrCorpusWriter(dst, terminal_shift=shift) as writer:
        for record in iter_corpus_records(src):
            writer.add(record)
            n += 1
    return n


def csr_to_text(src: str, dst: str) -> int:
    """``src`` (a CSR container) streamed back to the canonical text."""
    with open_corpus_csr(src) as corpus, open(dst, "w", encoding="utf-8") as f:
        for record in corpus.iter_records():
            write_corpus_record(f, record)
        return corpus.n_items


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="code2vec_tpu_torch.tools.corpus_convert",
                                     description="text corpus <-> memory-mapped CSR container")
    parser.add_argument("src", help="input corpus (text, or CSR with --to-text)")
    parser.add_argument("dst", help="output path")
    parser.add_argument("--to-text", action="store_true", default=False,
                        help="convert a CSR container back to canonical text "
                        "(default: text -> CSR)")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    if args.to_text:
        if not is_csr_corpus(args.src):
            raise SystemExit(f"{args.src!r} is not a CSR container")
        n = csr_to_text(args.src, args.dst)
        direction = "csr -> text"
    else:
        if is_csr_corpus(args.src):
            raise SystemExit(f"{args.src!r} is already a CSR container; did you mean --to-text?")
        n = text_to_csr(args.src, args.dst)
        direction = "text -> csr"
    print(f"{direction}: {n} records, {os.path.getsize(args.dst)} bytes "
          f"in {time.perf_counter() - t0:.1f}s -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
