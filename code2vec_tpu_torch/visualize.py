"""Code vectors for the TensorBoard embedding projector
(reference: visualize_code_vec.py:1-23).

Own copy of ``code2vec_tpu/visualize.py``. The reference feeds
``output/code.vec`` to tensorboardX ``SummaryWriter.add_embedding``; this
module does the same when tensorboardX imports, and always writes the
projector's standalone files (``vectors.tsv``, ``metadata.tsv`` and
``projector_config.pbtxt``), readable by the hosted projector
(projector.tensorflow.org) with no TensorFlow.

    python -m code2vec_tpu_torch.visualize [code.vec] [--log_dir DIR]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from code2vec_tpu_torch.formats.vectors_io import read_code_vectors

logger = logging.getLogger(__name__)


def write_projector_tsv(log_dir: str | os.PathLike, labels: list[str],
                        vectors: np.ndarray) -> dict[str, str]:
    """Write the projector's three files into ``log_dir``; return their paths."""
    os.makedirs(log_dir, exist_ok=True)
    paths = {
        "vectors": os.path.join(log_dir, "vectors.tsv"),
        "metadata": os.path.join(log_dir, "metadata.tsv"),
        "config": os.path.join(log_dir, "projector_config.pbtxt"),
    }
    with open(paths["vectors"], "w", encoding="utf-8") as f:
        for vec in vectors:
            f.write("\t".join(str(float(e)) for e in vec) + "\n")
    with open(paths["metadata"], "w", encoding="utf-8") as f:
        for label in labels:
            # one metadata column has no header row (the projector's rule)
            f.write(label.replace("\t", " ").replace("\n", " ") + "\n")
    with open(paths["config"], "w", encoding="utf-8") as f:
        f.write(
            "embeddings {\n"
            '  tensor_name: "code_vectors"\n'
            '  tensor_path: "vectors.tsv"\n'
            '  metadata_path: "metadata.tsv"\n'
            "}\n"
        )
    return paths


def visualize_code_vectors(vectors_path: str | os.PathLike,
                           log_dir: str | os.PathLike = "runs") -> dict[str, str]:
    """Read ``code.vec`` and write it for the projector; also
    ``add_embedding`` when tensorboardX imports (visualize_code_vec.py:23)."""
    labels, vectors = read_code_vectors(vectors_path)
    logger.info("loaded %d vectors (dim %d) from %s", len(labels),
                vectors.shape[1] if vectors.size else 0, vectors_path)
    paths = write_projector_tsv(log_dir, labels, vectors)
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.info("tensorboardX not available; wrote the projector TSVs only")
        return paths
    writer = SummaryWriter(str(log_dir))
    writer.add_embedding(vectors, metadata=labels, tag="code_vectors")
    writer.close()
    return paths


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Export code.vec for the TensorBoard embedding projector")
    parser.add_argument("vectors_path", nargs="?", default="./output/code.vec")
    parser.add_argument("--log_dir", type=str, default="runs")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s: %(message)s")
    visualize_code_vectors(args.vectors_path, args.log_dir)


if __name__ == "__main__":
    main()
