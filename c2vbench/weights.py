"""The model's initial weights, made on the device from the seed.

The init families of the port (``Code2Vec.reset_parameters``): std-normal
tables, lecun-normal encoder and label head, xavier-normal attention vector
over its ``[H, 1]`` shape, LayerNorm at one and zero, zero head bias. One
large call a tensor, in f32, the type they are trained and served in. The
names are the reference ``state_dict``'s, which the port's model and model
dir take as they stand. Both the program and the plain reference get these
tensors; a second call with the same seed gives the same bits.
"""

from __future__ import annotations

import math

from c2vbench.seeds import torch_generator

PARAMS = ("terminal_embedding.weight", "path_embedding.weight", "input_linear.weight",
          "input_layer_norm.weight", "input_layer_norm.bias", "attention_parameter",
          "output_linear.weight", "output_linear.bias")
TABLES = ("terminal_embedding.weight", "path_embedding.weight")


def make_weights(config: dict, seed: int, device) -> dict:
    import torch

    g = torch_generator(seed, "weights", device)
    et, ep, h = config["terminal_embed_size"], config["path_embed_size"], config["encode_size"]
    d = 2 * et + ep
    f32 = torch.float32

    def normal(shape, std=1.0):
        t = torch.empty(shape, dtype=f32, device=device)
        return t.normal_(0.0, std, generator=g)

    return {
        "terminal_embedding.weight": normal((config["terminal_count"], et)),
        "path_embedding.weight": normal((config["path_count"], ep)),
        "input_linear.weight": normal((h, d), math.sqrt(1.0 / d)),
        "input_layer_norm.weight": torch.ones(h, dtype=f32, device=device),
        "input_layer_norm.bias": torch.zeros(h, dtype=f32, device=device),
        "attention_parameter": normal((h,), math.sqrt(2.0 / (h + 1))),
        "output_linear.weight": normal((config["label_count"], h), math.sqrt(1.0 / h)),
        "output_linear.bias": torch.zeros(config["label_count"], dtype=f32, device=device),
    }
