"""``python -m code2vec_tpu_torch.tools.fleet_serve`` is ``python -m
code2vec_tpu_torch.serve.fleet``: the router, its replica workers and the
rolling hot-swap (counterpart of ``tools/fleet_serve.py``)."""

import sys

from code2vec_tpu_torch.serve.fleet.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
