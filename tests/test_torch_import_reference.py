"""The reference-checkpoint bridge of the port against JAX's, on the CPU.

The eight cases of ``tests/test_import_reference.py``, each run through
JAX's tool (``tools/*_reference_checkpoint.py``) and the port's
(``code2vec_tpu_torch.tools.*_reference_checkpoint``) on the same
synthetic reference ``state_dict`` and corpus:

- an import (plain head, margin head) writes the weights of JAX's import
  exactly (``state_dict_from_jax_params`` of the restored JAX params), the
  same ``label_vocab.txt`` and the same dims in ``model_meta.json``; the
  imported models' logits agree to atol 3e-5 / rtol 1e-4
  (``docs/PARITY.md:16``);
- a dimension mismatch and an unknown layout exit non-zero on both sides
  and write nothing;
- an export (both heads) gives the reference's tensors back exactly, and
  the same ``code2vec.model`` as JAX's export, tensor by tensor; a padded
  model exports with its vocab padding sliced, as JAX's does;
- an imported dir exports ``code.vec`` with one row per method, within
  the logits' tolerance of JAX's.

Beside them, ``interop.infer_dims`` and ``interop.reference_forward``
equal JAX's: the dims exactly, the logits to the same tolerance.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from code2vec_tpu_torch import interop
from code2vec_tpu_torch.tools import export_reference_checkpoint as port_export
from code2vec_tpu_torch.tools import import_reference_checkpoint as port_import

TOOLS = Path(__file__).resolve().parent.parent / "tools"
ATOL, RTOL = 3e-5, 1e-4  # docs/PARITY.md:16
DIMS = dict(dt=12, dp=14, encode=16)
HEADS = {"plain": False, "margin": True}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return _load("import_reference_checkpoint"), _load("export_reference_checkpoint")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from code2vec_tpu.data.reader import load_corpus as jax_load_corpus
    from code2vec_tpu.data.synth import SynthSpec, generate_corpus_files

    from code2vec_tpu_torch.data.reader import load_corpus

    out = tmp_path_factory.mktemp("refckpt_ds")
    spec = SynthSpec(n_methods=30, n_terminals=50, n_paths=60, n_labels=10,
                     mean_contexts=8.0, max_contexts=20, seed=7)
    paths = generate_corpus_files(out, spec)
    args = (paths["corpus"], paths["path_idx"], paths["terminal_idx"])
    return paths, jax_load_corpus(*args, cache=False), load_corpus(*args, cache=False)


def make_state_dict(data, margin: bool, seed=3):
    """The reference's layout (model/model.py:21-42), random from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    T, P, L = len(data.terminal_vocab), len(data.path_vocab), len(data.label_vocab)
    dt, dp, e = DIMS["dt"], DIMS["dp"], DIMS["encode"]
    sd = {
        "terminal_embedding.weight": torch.randn(T, dt, generator=g),
        "path_embedding.weight": torch.randn(P, dp, generator=g),
        "input_linear.weight": torch.randn(e, 2 * dt + dp, generator=g) * 0.2,
        "input_layer_norm.weight": torch.rand(e, generator=g) + 0.5,
        "input_layer_norm.bias": torch.randn(e, generator=g) * 0.1,
        "attention_parameter": torch.randn(e, generator=g) * 0.3,
    }
    if margin:
        sd["output_linear"] = torch.randn(L, e, generator=g) * 0.2
    else:
        sd["output_linear.weight"] = torch.randn(L, e, generator=g) * 0.2
        sd["output_linear.bias"] = torch.randn(L, generator=g) * 0.1
    return sd


def import_argv(paths, sd_path, out_dir):
    return ["--reference_model", str(sd_path), "--corpus_path", paths["corpus"],
            "--terminal_idx_path", paths["terminal_idx"], "--path_idx_path", paths["path_idx"],
            "--model_path", str(out_dir), "--max_path_length", "20", "--no_corpus_cache"]


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def imported(jax_tools, dataset, tmp_path_factory):
    """Each head's state_dict imported once by each tool."""
    paths, jax_data, _ = dataset
    out = {}
    for head, margin in HEADS.items():
        root = tmp_path_factory.mktemp(f"imported_{head}")
        sd = make_state_dict(jax_data, margin)
        torch.save(sd, root / "code2vec.model")
        jax_tools[0].main(import_argv(paths, root / "code2vec.model", root / "jax"))
        port_import.main(import_argv(paths, root / "code2vec.model", root / "port")
                         + ["--device", "cpu"])
        out[head] = {"sd": sd, "root": root}
    return out


def jax_model_config(data, margin, pad=1):
    from code2vec_tpu.models.code2vec import Code2VecConfig

    return Code2VecConfig(
        terminal_count=len(data.terminal_vocab), path_count=len(data.path_vocab),
        label_count=len(data.label_vocab), terminal_embed_size=DIMS["dt"],
        path_embed_size=DIMS["dp"], encode_size=DIMS["encode"], angular_margin_loss=margin,
        vocab_pad_multiple=pad)


def jax_batch(data, seed=0):
    from code2vec_tpu.data.pipeline import build_method_epoch, iter_batches

    rng = np.random.default_rng(seed)
    epoch = build_method_epoch(data, np.arange(4), 20, rng)
    return next(iter_batches(epoch, 4, rng=rng, pad_final=False))


def jax_restore(out_dir, data, margin):
    """The JAX checkpoint in ``out_dir``: ``(state, meta)``."""
    import jax

    from code2vec_tpu.checkpoint import restore_checkpoint
    from code2vec_tpu.train.config import TrainConfig
    from code2vec_tpu.train.step import create_train_state

    config = TrainConfig(batch_size=4, max_path_length=20)
    template = create_train_state(config, jax_model_config(data, margin),
                                  jax.random.PRNGKey(0), jax_batch(data))
    return restore_checkpoint(str(out_dir), template, prefer_best=True)


def port_checkpoint_weights(out_dir) -> dict:
    return torch.load(Path(out_dir) / "checkpoint_best.pt", map_location="cpu",
                      weights_only=False)["model"]


@pytest.mark.parametrize("head", HEADS)
def test_import_writes_jaxs_weights_vocab_and_dims(head, imported, dataset):
    import jax

    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig

    _, jax_data, _ = dataset
    margin = HEADS[head]
    root = imported[head]["root"]
    state, meta = jax_restore(root / "jax", jax_data, margin)
    assert meta.vocab_pad_multiple == 1
    port_meta = json.loads((root / "port" / "model_meta.json").read_text())
    config = Code2VecConfig(**{k: port_meta[k] for k in (
        "terminal_count", "path_count", "label_count", "terminal_embed_size",
        "path_embed_size", "encode_size", "angular_margin_loss", "vocab_pad_multiple")})
    want = interop.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), config)
    got = port_checkpoint_weights(root / "port")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    # the served weights file holds the same tensors
    served = interop.load_state_dict(str(root / "port"))
    for k in want:
        assert torch.equal(served[k], want[k]), k
    assert (root / "port" / "label_vocab.txt").read_bytes() == \
        (root / "jax" / "label_vocab.txt").read_bytes()
    jax_meta = json.loads((root / "jax" / "model_meta.json").read_text())
    for key in ("terminal_count", "path_count", "label_count", "terminal_embed_size",
                "path_embed_size", "encode_size", "angular_margin_loss", "angular_margin",
                "inverse_temp", "vocab_pad_multiple", "max_path_length"):
        assert port_meta[key] == jax_meta[key], key
    # the imported models' logits on one batch, eval mode
    batch = jax_batch(jax_data, seed=5)
    labels = np.maximum(np.asarray(batch["labels"]), 0)
    theirs, _, _ = state.apply_fn({"params": state.params}, batch["starts"], batch["paths"],
                                  batch["ends"], labels=labels, deterministic=True)
    model = Code2Vec(config)
    model.load_state_dict(got)
    model.eval()
    with torch.no_grad():
        ours = model(*(torch.from_numpy(np.asarray(batch[k])) for k in
                       ("starts", "paths", "ends")), labels=torch.from_numpy(labels))[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_dimension_mismatch_refuses(side, jax_tools, dataset, tmp_path):
    paths, jax_data, _ = dataset
    sd = make_state_dict(jax_data, margin=False)
    # one extra label row: the corpus no longer matches the checkpoint
    L = len(jax_data.label_vocab) + 1
    sd["output_linear.weight"] = torch.randn(L, DIMS["encode"])
    sd["output_linear.bias"] = torch.randn(L)
    torch.save(sd, tmp_path / "code2vec.model")
    argv = import_argv(paths, tmp_path / "code2vec.model", tmp_path / "out")
    tool = jax_tools[0] if side == "jax" else port_import
    with pytest.raises(SystemExit, match="do not match") as exc:
        tool.main(argv + (["--device", "cpu"] if side == "port" else []))
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_unknown_layout_refuses(side, jax_tools, dataset, tmp_path):
    paths, _, _ = dataset
    torch.save({"some.other.weight": torch.zeros(3)}, tmp_path / "code2vec.model")
    argv = import_argv(paths, tmp_path / "code2vec.model", tmp_path / "out")
    tool = jax_tools[0] if side == "jax" else port_import
    with pytest.raises(SystemExit, match="unrecognized state_dict layout") as exc:
        tool.main(argv + (["--device", "cpu"] if side == "port" else []))
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("head", HEADS)
def test_export_round_trips_and_equals_jaxs(head, imported, jax_tools, tmp_path, capsys):
    sd, root = imported[head]["sd"], imported[head]["root"]
    capsys.readouterr()
    port_export.main(["--model_path", str(root / "port"), "--output",
                      str(tmp_path / "port.model"), "--device", "cpu"])
    report = last_json(capsys)
    assert report["probe_max_abs_logit_diff"] < 2e-4
    assert report["angular_margin_loss"] is HEADS[head]
    jax_tools[1].main(["--model_path", str(root / "jax"), "--output",
                       str(tmp_path / "jax.model")])
    ours = torch.load(tmp_path / "port.model", map_location="cpu", weights_only=True)
    theirs = torch.load(tmp_path / "jax.model", map_location="cpu", weights_only=True)
    assert set(ours) == set(theirs) == set(sd)
    for k in sd:
        assert torch.equal(ours[k], sd[k]), k
        assert torch.equal(ours[k], theirs[k]), k


def test_export_slices_vocab_padding_as_jax(jax_tools, dataset, tmp_path, capsys):
    """A model with ``vocab_pad_multiple`` 8 exports its unpadded slices, on
    both sides, from the same weights."""
    import jax

    from code2vec_tpu.checkpoint import TrainMeta as JaxTrainMeta
    from code2vec_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
    from code2vec_tpu.predict import save_inference_meta as jax_save_inference_meta
    from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig
    from code2vec_tpu.train.step import create_train_state

    from code2vec_tpu_torch.checkpoint import TrainMeta, save_checkpoint
    from code2vec_tpu_torch.models.code2vec import Code2Vec, Code2VecConfig
    from code2vec_tpu_torch.predict import save_inference_meta
    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.step import make_optimizer

    _, jax_data, data = dataset
    pad = 8  # the vocab sizes are not multiples of 8: real pad rows
    jax_mc = jax_model_config(jax_data, False, pad)
    assert jax_mc.padded(jax_mc.terminal_count) > jax_mc.terminal_count
    jax_tc = JaxTrainConfig(batch_size=4, max_path_length=20, terminal_embed_size=DIMS["dt"],
                            path_embed_size=DIMS["dp"], encode_size=DIMS["encode"],
                            vocab_pad_multiple=pad)
    state = create_train_state(jax_tc, jax_mc, jax.random.PRNGKey(2), jax_batch(jax_data, 1))
    jax_dir = tmp_path / "jax_padded"
    os.makedirs(jax_dir)
    jax_save_checkpoint(str(jax_dir), state, JaxTrainMeta(rng_impl=jax_tc.rng_impl,
                                                          vocab_pad_multiple=pad), slot="best")
    jax_save_inference_meta(str(jax_dir), jax_tc, jax_mc, jax_data)

    config = Code2VecConfig(terminal_count=jax_mc.terminal_count,
                            path_count=jax_mc.path_count, label_count=jax_mc.label_count,
                            terminal_embed_size=DIMS["dt"], path_embed_size=DIMS["dp"],
                            encode_size=DIMS["encode"], vocab_pad_multiple=pad)
    model = Code2Vec(config)
    model.load_state_dict(interop.state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params), config))
    tc = TrainConfig(batch_size=4, max_path_length=20, terminal_embed_size=DIMS["dt"],
                     path_embed_size=DIMS["dp"], encode_size=DIMS["encode"],
                     vocab_pad_multiple=pad)
    port_dir = tmp_path / "port_padded"
    save_inference_meta(str(port_dir), tc, config, data)
    save_checkpoint(str(port_dir), "best", model, make_optimizer(model, tc),
                    TrainMeta(vocab_pad_multiple=pad), np.random.default_rng(0))

    jax_tools[1].main(["--model_path", str(jax_dir), "--output", str(tmp_path / "jax.model")])
    capsys.readouterr()
    port_export.main(["--model_path", str(port_dir), "--output", str(tmp_path / "port.model"),
                      "--device", "cpu"])
    assert last_json(capsys)["probe_max_abs_logit_diff"] < 2e-4
    ours = torch.load(tmp_path / "port.model", map_location="cpu", weights_only=True)
    theirs = torch.load(tmp_path / "jax.model", map_location="cpu", weights_only=True)
    T, P, L = jax_mc.terminal_count, jax_mc.path_count, jax_mc.label_count
    assert ours["terminal_embedding.weight"].shape == (T, DIMS["dt"])
    assert ours["path_embedding.weight"].shape == (P, DIMS["dp"])
    assert ours["output_linear.weight"].shape == (L, DIMS["encode"])
    assert set(ours) == set(theirs)
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k


def test_exports_vectors_from_imported_checkpoint(imported, dataset, tmp_path):
    """The imported dir plugs into ``--export_only``: ``code.vec`` with one
    row per method, JAX's rows within the logits' tolerance."""
    from code2vec_tpu.export import export_from_checkpoint as jax_export_vectors
    from code2vec_tpu.train.config import TrainConfig as JaxTrainConfig

    from code2vec_tpu_torch.export import export_from_checkpoint
    from code2vec_tpu_torch.formats.vectors_io import read_code_vectors
    from code2vec_tpu_torch.train.config import TrainConfig

    _, jax_data, data = dataset
    root = imported["plain"]["root"]
    recipe = dict(batch_size=8, max_path_length=20, terminal_embed_size=DIMS["dt"],
                  path_embed_size=DIMS["dp"], encode_size=DIMS["encode"])
    export_from_checkpoint(TrainConfig(**recipe), data, str(root / "port"),
                           str(tmp_path / "port.vec"), device="cpu")
    jax_export_vectors(JaxTrainConfig(**recipe), jax_data, str(root / "jax"),
                       str(tmp_path / "jax.vec"))
    labels, rows = read_code_vectors(str(tmp_path / "port.vec"))
    jax_labels, jax_rows = read_code_vectors(str(tmp_path / "jax.vec"))
    assert len(labels) == data.n_items and labels == jax_labels
    np.testing.assert_allclose(rows, jax_rows, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head", HEADS)
def test_infer_dims_and_reference_forward_equal_jaxs(head, dataset):
    from code2vec_tpu import interop as jax_interop

    _, jax_data, _ = dataset
    sd = make_state_dict(jax_data, HEADS[head], seed=11)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    dims = interop.infer_dims(sd)
    assert dims == jax_interop.infer_dims(np_sd)
    batch = jax_batch(jax_data, seed=2)
    ids = [np.asarray(batch[k]) for k in ("starts", "paths", "ends")]
    labels = np.maximum(np.asarray(batch["labels"]), 0)
    ours = interop.reference_forward(sd, dims, *ids, labels, 0.5, 30.0)
    theirs = jax_interop.reference_forward(np_sd, dims, *ids, labels, 0.5, 30.0)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL, rtol=RTOL)
    bad = dict(sd, **{"input_linear.weight": torch.zeros(DIMS["encode"], 3)})
    with pytest.raises(ValueError, match="input_linear.weight"):
        interop.infer_dims(bad)


def test_imported_dir_resumes_as_a_fresh_run_from_its_weights(imported, dataset, tmp_path):
    """``--resume`` on the imported dir trains exactly as a fresh run started
    from the reference's weights: the checkpoint holds the weights, fresh
    Adam moments and the data and dropout streams of a run at epoch 0."""
    import shutil

    from code2vec_tpu_torch.train.config import TrainConfig
    from code2vec_tpu_torch.train.loop import train

    _, _, data = dataset
    sd, root = imported["plain"]["sd"], imported["plain"]["root"]
    out = tmp_path / "resumed"
    shutil.copytree(root / "port", out)
    config = TrainConfig(batch_size=8, max_path_length=20, terminal_embed_size=DIMS["dt"],
                         path_embed_size=DIMS["dp"], encode_size=DIMS["encode"], max_epoch=2,
                         print_sample_cycle=0)
    resumed = train(config.with_updates(resume=True), data, out_dir=str(out), device="cpu")
    fresh = train(config, data, device="cpu", initial_state_dict=sd)
    assert [h["train_loss"] for h in resumed.history] == [h["train_loss"] for h in fresh.history]
    got, want = resumed.model.state_dict(), fresh.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
