"""Artifact formats shared with the JAX package (own copies), exported as
``code2vec_tpu/formats/__init__.py`` exports them:

- ``corpus.txt``        blank-line-separated method records
- ``*_idxs.txt``        vocab files, index 0 = ``<PAD/>``
- ``params.txt``        extraction stats, ``key:value`` lines
- ``code.vec``          exported code vectors
- test-result TSV       per-example prediction dump
"""

from code2vec_tpu_torch.formats.vocab_io import (
    read_vocab,
    write_vocab,
    write_vocab_from_names,
)
from code2vec_tpu_torch.formats.corpus_io import (
    CorpusRecord,
    iter_corpus_records,
    read_corpus,
    write_corpus,
    write_corpus_record,
)
from code2vec_tpu_torch.formats.params_io import read_params, write_params
from code2vec_tpu_torch.formats.vectors_io import (
    read_code_vectors,
    write_code_vectors_header,
    append_code_vectors,
    write_test_results,
)
