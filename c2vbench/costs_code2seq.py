"""code2seq's closed-form operation counts: what its cell's ``mfu`` and the
path encoder's roofline divide by (the peaks are ``costs.py``'s).

Counted at the padded shape a step runs: ``B`` rows of ``L`` slots, every
path ``P`` nodes in each direction, ``T + 1`` decoder steps, ``V`` target
rows. A product of ``[m, k]`` by ``[k, n]`` is ``2 m k n``; an LSTM step of
input ``i`` and state ``h`` is its two products, ``2 4h (i + h)``, and ``10
h`` for its gates' activations and updates; a softmax or log-softmax over
``n`` is ``5 n``. A training step is three forwards (the backward two),
nothing recomputed counted.
"""

from __future__ import annotations


def lstm_step_flops(inputs: int, hidden: int) -> float:
    return 2.0 * 4 * hidden * (inputs + hidden) + 10.0 * hidden


def forward_flops(batch: int, width: int, *, embed: int, rnn: int, decoder: int, nodes: int,
                  name_parts: int, target_parts: int, targets: int) -> float:
    b, l, e, d = float(batch), float(width), float(embed), float(decoder)
    h = rnn // 2
    slots = b * l
    terminals = 2.0 * slots * name_parts * e
    paths = 2.0 * slots * nodes * lstm_step_flops(embed, h)
    context = 2.0 * slots * (2 * e + rnn) * d + slots * d
    step = (b * lstm_step_flops(embed + decoder, decoder) + 2.0 * b * d * d
            + 2.0 * slots * d + 5.0 * slots + 2.0 * slots * d + 2.0 * b * 2 * d * d
            + 2.0 * b * d * targets + 5.0 * b * targets)
    return terminals + paths + context + (target_parts + 1) * step


def train_step_flops(batch: int, width: int, **dims) -> float:
    return 3.0 * forward_flops(batch, width, **dims)


def dims_of(config: dict) -> dict:
    """The keyword arguments of :func:`forward_flops` from a configuration file."""
    return dict(embed=config["embed_size"], rnn=config["rnn_size"],
                decoder=config["decoder_size"], nodes=config["max_path_nodes"],
                name_parts=config["max_name_parts"], target_parts=config["max_target_parts"],
                targets=3 + config["target_vocab"])


def path_encoder_forward_flops(steps: float, embed: int, rnn: int) -> float:
    """The path LSTMs' forward over ``steps`` node steps (both directions
    counted in ``steps``)."""
    return steps * lstm_step_flops(embed, rnn // 2)
