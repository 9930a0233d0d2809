"""``python -m code2vec_tpu_torch``: train (see ``cli.py``)."""

import sys

from code2vec_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
