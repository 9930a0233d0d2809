"""Approximate-nearest-neighbor retrieval: IVF-PQ, built and searched on the card.

Counterpart of ``code2vec_tpu/ann``:

- ``kmeans.py``     mini-batch Lloyd's k-means (k-means++ seeding), the
                    distance work on the card, the seeded draws and the
                    float64 centroid fold on the host;
- ``pq.py``         product quantization of coarse residuals (per-row absmax
                    scale, ``ops/quant.row_absmax``);
- ``lut_kernel.py`` K5, the LUT cell-scoring kernel (``csrc/lut_score.cu``),
                    and its gather-based plain version;
- ``index.py``      :class:`IvfPqIndex`, build/save/load through the
                    ``formats/ann_io.py`` container, and :class:`AnnSearcher`.
"""

from code2vec_tpu_torch.ann.index import (  # noqa: F401
    AnnSearcher,
    IvfPqIndex,
    build_index,
    load_index,
    save_index,
)
