"""code2seq's inputs beside the corpus, made on the device from the seed:
the expansion tables and the model's initial weights.

The corpus (``corpus.py``) holds one id a terminal, a path and a label, in
java14m's id spaces. The tables give each id its pieces, as the program's
``data/expansion.py`` gives them from vocab strings (here there are no
strings, so they are drawn; the configuration's ``tables`` block states the
rules):

- each terminal ``1..`` its subtokens, their count drawn from
  ``subtokens_per_terminal`` (the share of 1, 2, ... subtokens), their ids
  Zipf-like with exponent ``zipf_exponent`` over the subtoken vocabulary;
- each path ``1..`` its nodes, their count uniform on ``[min_nodes,
  max_nodes]``, their ids uniform over the node vocabulary;
- each label its target subtokens, their count drawn from
  ``target_parts``, their ids Zipf-like over the target vocabulary;
- row 0 of the terminal and path tables (PAD) holds no piece.

Reserved ids, the program's rule (``data/expansion.py``): 0 PAD (and the
targets' end of name), 1 UNK, 2 the targets' start; so the tables have
``2 + subtoken_vocab``, ``2 + node_vocab`` and ``3 + target_vocab`` rows.

The weights carry the program's ``state_dict`` names and its init families
(``Code2Seq.reset_parameters``): the tables uniform within ``sqrt(3 /
width)``, every kernel uniform within ``sqrt(6 / (fan_in + fan_out))`` over
TF's shape (an LSTM's ``[in + H, 4H]``), zero biases but each LSTM's forget
gate (torch's second quarter of ``bias_ih``) at 1.0. Both the program and
the plain reference get these tensors; the same seed gives the same bits.
"""

from __future__ import annotations

import math

import numpy as np

from c2vbench.seeds import torch_generator

PAD, UNK, SOS = 0, 1, 2
SUBTOKEN_SPECIALS, NODE_SPECIALS, TARGET_SPECIALS = 2, 2, 3
# the tables' stream, apart from seeds.STREAMS' (whose ids run to 8)
TABLES_STREAM = 9

TABLES = ("subtoken_embedding.weight", "node_embedding.weight", "target_embedding.weight")


def table_rows(config: dict) -> tuple[int, int, int]:
    """Rows of the subtoken, node and target tables."""
    return (SUBTOKEN_SPECIALS + config["subtoken_vocab"], NODE_SPECIALS + config["node_vocab"],
            TARGET_SPECIALS + config["target_vocab"])


def params_of(config: dict) -> tuple[str, ...]:
    """The weights' names, in the order :func:`make_weights` draws them."""
    lstm = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
    return (TABLES + tuple(f"path_{d}.{k}" for d in ("fw", "bw") for k in lstm)
            + ("context_linear.weight", "decoder_cell.weight_ih", "decoder_cell.weight_hh",
               "decoder_cell.bias_ih", "decoder_cell.bias_hh", "attention_linear.weight",
               "attention_output.weight", "output_linear.weight"))


def _generator(seed: int, device):
    import torch

    g = torch.Generator(device=device)
    state = np.random.SeedSequence([int(seed) % 2**64, TABLES_STREAM]).generate_state(
        1, np.uint64)[0]
    g.manual_seed(int(state) >> 1)
    return g


def _counts(shares: list, n: int, g, device):
    """``n`` counts ``1..len(shares)`` drawn with the given shares."""
    import torch

    edges = torch.tensor(np.cumsum(shares)[:-1], dtype=torch.float64, device=device)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return 1 + torch.searchsorted(edges, u, right=True)


def _zipf(shape, vocab: int, exponent: float, g, device):
    """Ranks ``[0, vocab)`` drawn with chance proportional to ``(rank +
    1) ** -exponent``."""
    import torch

    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) ** -exponent
    cdf = torch.cumsum(w, 0)
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)


def draw_tables(config: dict, seed: int, device) -> dict:
    """``{term_subtokens, path_nodes, path_lengths, label_targets,
    label_lengths}``, int32 on ``device``."""
    import torch

    spec, g = config["tables"], _generator(seed, device)
    i32 = torch.int32
    tc, pc, nl = config["terminal_count"], config["path_count"], config["label_count"]
    s, p, t = config["max_name_parts"], config["max_path_nodes"], config["max_target_parts"]
    zipf = spec["zipf_exponent"]

    def cut(ids, counts, width):
        return torch.where(torch.arange(width, device=device) < counts.unsqueeze(-1), ids,
                           0).to(i32)

    n_sub = _counts(spec["subtokens_per_terminal"], tc, g, device)
    subs = SUBTOKEN_SPECIALS + _zipf((tc, s), config["subtoken_vocab"], zipf, g, device)
    term = cut(subs, n_sub, s)
    term[0] = PAD
    n_nodes = torch.randint(spec["min_nodes"], spec["max_nodes"] + 1, (pc,), generator=g,
                            device=device)
    n_nodes[0] = 0
    nodes = torch.randint(NODE_SPECIALS, NODE_SPECIALS + config["node_vocab"], (pc, p),
                          generator=g, device=device)
    n_tgt = _counts(spec["target_parts"], nl, g, device)
    tgts = TARGET_SPECIALS + _zipf((nl, t), config["target_vocab"], zipf, g, device)
    return {"term_subtokens": term, "path_nodes": cut(nodes, n_nodes, p),
            "path_lengths": n_nodes.to(i32), "label_targets": cut(tgts, n_tgt, t),
            "label_lengths": n_tgt.to(i32)}


def make_weights(config: dict, seed: int, device) -> dict:
    import torch

    g = torch_generator(seed, "weights", device)
    e, h, d = config["embed_size"], config["rnn_size"] // 2, config["decoder_size"]
    sub_rows, node_rows, tgt_rows = table_rows(config)
    shapes = {
        "subtoken_embedding.weight": (sub_rows, e), "node_embedding.weight": (node_rows, e),
        "target_embedding.weight": (tgt_rows, e),
        "context_linear.weight": (d, 2 * e + 2 * h), "decoder_cell.weight_ih": (4 * d, e + d),
        "decoder_cell.weight_hh": (4 * d, d), "decoder_cell.bias_ih": (4 * d,),
        "decoder_cell.bias_hh": (4 * d,), "attention_linear.weight": (d, d),
        "attention_output.weight": (d, 2 * d), "output_linear.weight": (tgt_rows, d),
    }
    for direction in ("fw", "bw"):
        shapes.update({f"path_{direction}.weight_ih_l0": (4 * h, e),
                       f"path_{direction}.weight_hh_l0": (4 * h, h),
                       f"path_{direction}.bias_ih_l0": (4 * h,),
                       f"path_{direction}.bias_hh_l0": (4 * h,)})
    out = {}
    for name in params_of(config):
        shape = shapes[name]
        t = torch.zeros(shape, dtype=torch.float32, device=device)
        if name in TABLES:
            limit = math.sqrt(3.0 / shape[1])
        elif "bias" in name:
            if "bias_ih" in name:  # the forget gate: forget_bias 1.0
                hidden = shape[0] // 4
                t[hidden:2 * hidden] = 1.0
            out[name] = t
            continue
        elif "weight_ih" in name or "weight_hh" in name:
            hidden = shape[0] // 4
            inputs = shapes[name.replace("weight_hh", "weight_ih")][1]
            limit = math.sqrt(6.0 / (inputs + hidden + 4 * hidden))
        else:
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = t.uniform_(-limit, limit, generator=g)
    return out
