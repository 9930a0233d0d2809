"""Parallelism over a ``torch.distributed`` mesh: data, model and context.

Counterpart of ``code2vec_tpu/parallel``: the ``(data, model, ctx)`` mesh
of one rank a card (``mesh.py``), the process group, the feeding and the
collective autograd Functions (``distributed.py``), the sharding rules and
the checkpoint's sidecar (``shardings.py``), the sharded steps
(``step.py``) and the context-parallel pool (``context.py``).
"""

from code2vec_tpu_torch.parallel.mesh import (
    AXIS_CTX,
    AXIS_DATA,
    AXIS_MODEL,
    make_mesh,
)
from code2vec_tpu_torch.parallel.shardings import (
    batch_shardings,
    param_shardings,
    shard_batch,
    shard_model,
    shard_state,
    state_shardings,
    unshard_state,
)
