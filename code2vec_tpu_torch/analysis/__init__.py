"""Static analysis for PyTorch step footguns + call-time step contracts.

Counterpart of ``code2vec_tpu/analysis/``. Three layers, one defect
class: bugs that never raise — a host sync that idles the card every step,
a dtype that drifts and gives a step a new input signature, a broadcast
that trains on the wrong loss, a rank-dependent collective order that
hangs.

- :mod:`code2vec_tpu_torch.analysis.torchlint` — pure-``ast`` lint rules
  (TX000-TX007): dtype-less literal tensors entering a batch or a step,
  host syncs, tensor branches and impurity inside device bodies,
  set-iteration order, per-step host syncs in step loops.
- :mod:`code2vec_tpu_torch.analysis.sharding_check` — every sharding spec
  list and mesh access cross-validated against the mesh module's declared
  axis names (SC001-SC003); ``validate_runtime_spec`` for the restore.
- :mod:`code2vec_tpu_torch.analysis.concurrency` (CX001-CX005) and
  :mod:`code2vec_tpu_torch.analysis.lifecycle` (RS001-RS006) — lock and
  resource discipline.
- :mod:`code2vec_tpu_torch.analysis.contracts` — ``@shape_contract``:
  shape/dtype/weakness validation of step and kernel inputs on every call
  (reads shapes and dtypes only, never syncs); wired into ``train/step.py``
  and the K1, K2-K4 and K5 entries.

Run the static layers with ``python -m code2vec_tpu_torch.analysis``
against the checked-in baseline (``analysis/baseline.json``). The lint
layers import only the stdlib — no torch, no numpy — so the whole pass
costs parse time.
"""

from code2vec_tpu_torch.analysis.sharding_check import (  # noqa: F401
    check_paths,
    check_source,
    declared_axes,
    validate_runtime_spec,
)
from code2vec_tpu_torch.analysis.torchlint import (  # noqa: F401
    RECOMPILE_HINT_RULES,
    RULES,
    Finding,
    Rule,
    lint_paths,
    lint_source,
)

# the contract layer imports torch (on its first check) — loaded on demand
# (PEP 562) so `python -m code2vec_tpu_torch.analysis` runs on a bare
# interpreter with neither torch nor numpy
_CONTRACT_EXPORTS = ("ArgSpec", "ContractError", "shape_contract", "spec")


def __getattr__(name: str):
    if name in _CONTRACT_EXPORTS:
        from code2vec_tpu_torch.analysis import contracts

        return getattr(contracts, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
