"""Metric sinks: the reference's three observability backends
(reference main.py:183-205): stdlib logging, Floyd-style JSON lines on
stdout, and TensorBoard scalars.

Own copy of ``code2vec_tpu/sinks.py``. A sink is a plain callable
``(epoch, metrics_dict) -> None``; :func:`code2vec_tpu_torch.train.loop.train`
takes any number of them (``sinks``) and drives them as consumers of its
event stream (``obs.events.sink_consumer``), so the sinks' output and the
``--events_dir`` log derive from one metrics dict. A sink may carry a
``close()``; the loop calls it in its ``finally`` block (the TensorBoard
writer's last flush).

Non-finite metrics (a diverged ``train_loss``) print as ``null`` with the
original in a string ``"raw"`` field (:func:`obs.events.metric_record`):
``json.dumps`` would print bare ``NaN``/``Infinity``, which is not JSON.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Callable

from code2vec_tpu_torch.obs.events import metric_record

logger = logging.getLogger(__name__)

MetricSink = Callable[[int, dict[str, float]], None]


def logging_sink(epoch: int, metrics: dict[str, float]) -> None:
    """Per-epoch JSON metric lines through stdlib logging, the default
    sink (the reference's shape, main.py:183-205)."""
    logger.info("epoch %d", epoch)
    for name, value in metrics.items():
        logger.info("%s", json.dumps(metric_record(name, value)))


def floyd_sink(epoch: int, metrics: dict[str, float]) -> None:
    """One ``{"metric": name, "value": value}`` JSON line a metric on
    stdout (reference ``--env floyd``, main.py:183-190)."""
    for name, value in metrics.items():
        sys.stdout.write(json.dumps(metric_record(name, value)) + "\n")
    sys.stdout.flush()


def tensorboard_sink(log_dir: str) -> MetricSink:
    """TensorBoard scalars (reference ``--env tensorboard``,
    main.py:152-155, 199-205): each metric a scalar series under its name,
    stepped by epoch. The sink's ``close()`` closes the writer.

    Needs ``tensorboardX``, imported here and not at module import (the
    reference's ``--env``-gated import, main.py:87-88); without it this
    raises ImportError."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "tensorboard_sink requires tensorboardX; install it or drop --env tensorboard"
        ) from e

    writer = SummaryWriter(log_dir)

    def sink(epoch: int, metrics: dict[str, float]) -> None:
        for name, value in metrics.items():
            writer.add_scalar(name, value, epoch)
        writer.flush()

    sink.close = writer.close
    return sink
