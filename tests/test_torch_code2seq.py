"""code2seq in the port (``models/code2seq.py``, ``data/expansion.py``) on the
CPU, against the plain gate-loop reference ``tests/plain_code2seq.py``.

- The loss and every parameter's gradient, in eval mode and in training
  mode with the keep masks drawn again from the model's seed; the decoder's
  teacher-forced logits; greedy decoding; two Nesterov steps through
  ``train_step``. The batch holds paths of 3 and 9 nodes, PAD contexts, a
  5-subtoken terminal, a 6-part target and a masked tail row.
- The expansion tables from real vocab strings: the ``↑``/``↓`` split,
  camelCase and underscore subtokens, the caps to UNK and to the widths.
- The CLI trains two epochs, evaluates, saves, and resumes a third; the
  rates decay by epoch; what code2seq does not support is refused by name.
- The tracer's ``path_encoder`` and ``decoder`` spans and their counters.
- The benchmark's side: its plain reference (``c2vbench/reference_code2seq.py``)
  gives the tests' reference's loss; the harness finds the new cell and its
  metrics, which read nothing untraced; its yardstick files import nothing
  of the port or JAX.

Tolerances (both sides f32 on the CPU, the same equations summed in other
orders: ``nn.LSTM``'s fused gate products against the reference's two, the
decoder's ``bmm`` against an elementwise sum): the loss and the logits
within rtol 1e-5, each gradient and each stepped parameter within atol 1e-6
+ rtol 1e-4 of the reference (a few ulps of f32 carried through <= 9 LSTM
steps and 7 decoder steps; a swapped gate, a wrong reversal or a missed
mask moves them by whole percents).
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from c2vbench import guard, harness
from code2vec_tpu_torch.data.expansion import build_expansions, split_nodes, split_subtokens
from code2vec_tpu_torch.data.vocab import Vocab
from code2vec_tpu_torch.formats.vocab_io import read_vocab
from code2vec_tpu_torch.metrics import sequence_subtoken_match
from code2vec_tpu_torch.models.code2seq import Code2Seq, Code2SeqConfig
from code2vec_tpu_torch.obs.trace import Tracer, set_tracer
from code2vec_tpu_torch.train.config import TrainConfig
from code2vec_tpu_torch.train.step import eval_step, make_optimizer, train_step

def _load_plain():
    """``tests/plain_code2seq.py`` by its path (an installed package may own
    the name ``tests``)."""
    spec = importlib.util.spec_from_file_location(
        "plain_code2seq", Path(__file__).resolve().parent / "plain_code2seq.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


plain = _load_plain()
CFG = Code2SeqConfig(subtoken_count=25, node_count=14, target_count=20, embed_size=6,
                     rnn_size=8, decoder_size=10)
B, L = 5, 8
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def make_tables(seed: int = 0) -> dict:
    g = np.random.default_rng(seed)
    t, p, n = 40, 30, 12
    sub_n = g.integers(1, 6, t)
    term = np.where(np.arange(5) < sub_n[:, None], g.integers(2, CFG.subtoken_count, (t, 5)), 0)
    term[0] = 0
    term[3] = g.integers(2, CFG.subtoken_count, 5)  # a 5-subtoken terminal
    lengths = g.integers(1, 10, p)
    lengths[0], lengths[4], lengths[5] = 0, 3, 9
    nodes = np.where(np.arange(9) < lengths[:, None], g.integers(2, CFG.node_count, (p, 9)), 0)
    tgt_n = g.integers(1, 7, n)
    tgt_n[2] = 6  # a 6-part target
    tgt = np.where(np.arange(6) < tgt_n[:, None], g.integers(3, CFG.target_count, (n, 6)), 0)
    return {"term_subtokens": torch.tensor(term, dtype=torch.int32),
            "path_nodes": torch.tensor(nodes, dtype=torch.int32),
            "path_lengths": torch.tensor(lengths, dtype=torch.int32),
            "label_targets": torch.tensor(tgt, dtype=torch.int32),
            "label_lengths": torch.tensor(tgt_n, dtype=torch.int32)}


def make_batch(seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    starts = torch.randint(1, 40, (B, L), generator=g, dtype=torch.int32)
    paths = torch.randint(1, 30, (B, L), generator=g, dtype=torch.int32)
    ends = torch.randint(1, 40, (B, L), generator=g, dtype=torch.int32)
    starts[0, 0], paths[0, 0], paths[1, 0], paths[2, 2] = 3, 4, 5, 4  # 5 parts; 3 and 9 nodes
    for t in (starts, paths, ends):  # PAD contexts
        t[0, 5:] = 0
        t[3, 2:] = 0
    labels = torch.tensor([2, 0, 7, 11, 5], dtype=torch.int32)
    mask = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])  # the masked tail row
    return {"starts": starts, "paths": paths, "ends": ends, "labels": labels,
            "example_mask": mask}


def model_and_params(cfg=CFG, seed: int = 0):
    model = Code2Seq(cfg, make_tables())
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model, {k: v.detach().clone().requires_grad_(True)
                   for k, v in model.named_parameters()}


def close(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_the_batch_holds_the_edge_cases():
    t, b = make_tables(), make_batch()
    n = t["path_lengths"][b["paths"].long()]
    assert {3, 9} <= set(n[b["starts"] > 0].tolist()) and (n[b["starts"] == 0] == 0).all()
    assert (t["term_subtokens"][3] > 0).sum() == 5 and b["starts"][0, 0] == 3
    assert t["label_lengths"][2] == 6 and b["labels"][0] == 2
    assert b["example_mask"][-1] == 0


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_loss_and_every_gradient_match_the_plain_reference(mode):
    model, params = model_and_params()
    batch = make_batch()
    keeps = (None, None)
    if mode == "train":
        model.seed_dropout(9)
        model.train()
        g = torch.Generator().manual_seed(9)
        keeps = (torch.empty(B, L, 2 * CFG.embed_size + CFG.rnn_size).bernoulli_(0.75, generator=g)
                 / 0.75,
                 torch.empty(CFG.decode_steps, B, CFG.decoder_size).bernoulli_(0.5, generator=g)
                 / 0.5)
    else:
        model.eval()
    loss = model.loss(batch)
    loss.backward()
    with plain.full_f32():
        want = plain.loss(params, make_tables(), batch, keeps)
        want.backward()
    close(loss.detach(), want.detach(), atol=0.0, rtol=LOSS_RTOL)
    for name, p in model.named_parameters():
        close(p.grad, params[name].grad)


def test_the_masked_tail_row_adds_nothing():
    model, _ = model_and_params()
    model.eval()
    batch = make_batch()
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][-1] = 3
    assert torch.equal(model.loss(batch), model.loss(other))


def test_decoder_logits_match_the_plain_reference():
    model, params = model_and_params(seed=3)
    batch = make_batch(4)
    got = model.logits(batch)
    t = make_tables()
    with torch.no_grad(), plain.full_f32():
        z, real = plain.contexts(params, t, batch["starts"], batch["paths"], batch["ends"])
        tgt = t["label_targets"][batch["labels"].long()].long()
        y_in = torch.cat([torch.full((B, 1), plain.SOS), tgt], dim=1)
        want = plain.teacher_logits(params, z, real, y_in)
    assert got.shape == (B, CFG.decode_steps, CFG.target_count)
    close(got, want, atol=1e-6, rtol=LOSS_RTOL)


def test_greedy_decoding_matches_the_plain_reference():
    model, params = model_and_params(seed=5)
    batch = make_batch(6)
    preds, logp = model.decode(batch["starts"], batch["paths"], batch["ends"])
    with torch.no_grad(), plain.full_f32():
        want = plain.greedy(params, make_tables(), batch, CFG.decode_steps)
    assert torch.equal(preds, want)
    assert logp.shape == (B,) and (logp <= 0).all()
    out = eval_step(model, batch, torch.ones(1))
    assert torch.equal(out["preds"], want) and out["loss"].shape == ()


def test_two_nesterov_steps_match_the_plain_steps():
    cfg = Code2SeqConfig(**{**CFG.__dict__, "embed_dropout_prob": 0.0, "rnn_dropout_prob": 0.0})
    model, params = model_and_params(cfg, seed=7)
    opt = make_optimizer(model, TrainConfig(lr=0.5))
    assert isinstance(opt, torch.optim.SGD) and opt.defaults["nesterov"]
    bufs = {}
    for seed in (8, 9):
        batch = make_batch(seed)
        train_step(model, opt, batch, torch.ones(1))
        with plain.full_f32():
            loss = plain.loss(params, make_tables(), batch)
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        plain.nesterov_step(params, grads, bufs, 0.5, 0.95)
    for name, p in model.named_parameters():
        close(p.detach(), params[name].detach())


def test_pad_contexts_encode_to_zero_and_the_flags_are_restored():
    model, _ = model_and_params()
    batch = make_batch()
    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    model.loss(batch)
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags
    z, real = model._contexts(batch["starts"], batch["paths"], batch["ends"])
    assert (z[~real] == 0).all() and (z[real] != 0).any()


def test_spans_and_counters_of_a_traced_step():
    model, _ = model_and_params()
    opt = make_optimizer(model, TrainConfig())
    batch = make_batch()
    tracer = Tracer()
    previous = set_tracer(tracer)
    try:
        train_step(model, opt, batch, torch.ones(1))
    finally:
        set_tracer(previous)
    s = tracer.summary()
    assert {"train_step", "forward", "path_encoder", "decoder", "backward",
            "optimizer"} <= set(s)
    n = make_tables()["path_lengths"][batch["paths"].long()]
    real = batch["starts"] > 0
    pe, dec = s["path_encoder"]["args"], s["decoder"]["args"]
    assert pe["path_steps_real"] == 2 * int(n[real].sum())
    assert pe["path_steps_run"] == 2 * B * L * CFG.max_path_nodes
    lengths = make_tables()["label_lengths"][batch["labels"].long()]
    assert dec["decode_steps"] == CFG.decode_steps
    assert dec["target_tokens"] == int(((lengths + 1) * batch["example_mask"]).sum())


# -- the expansion tables from vocab strings ---------------------------------


def test_subtokens_and_nodes_of_real_strings():
    assert split_subtokens("getValue") == ["get", "value"]
    assert split_subtokens("my_var2") == ["my", "var"]
    assert split_subtokens("HTTPServer") == ["http", "server"]
    assert split_subtokens("parseXMLFile") == ["parse", "xml", "file"]
    assert split_subtokens("@question") == ["@question"]
    assert split_subtokens("+") == ["+"]
    assert split_nodes("SimpleName↑MethodCallExpr↓NameExpr") == [
        "SimpleName", "MethodCallExpr", "NameExpr"]


def test_expansion_tables_from_vocab_files(tmp_path):
    (tmp_path / "t.txt").write_text("0\t<PAD/>\n1\tgetValue\n2\tset_value_now\n3\tvalue\n"
                                    "4\tparseXMLFileAndSetValueSoonHere\n5\tx\n", encoding="utf-8")
    long_path = "↑".join(f"N{i}" for i in range(11))
    (tmp_path / "p.txt").write_text(f"0\t<PAD/>\n1\tA↑B↓C\n2\t{long_path}\n3\tA\n",
                                    encoding="utf-8")
    terms = read_vocab(tmp_path / "t.txt", extra_tokens=["@question"])
    paths = read_vocab(tmp_path / "p.txt")
    labels = Vocab()
    for name in ("getValue", "setValue", "parseAllTheXmlFilesOfTheProjectNow"):
        labels.add_label(name)
    exp = build_expansions(terms, paths, labels, subtoken_vocab=3, target_vocab=4)
    # subtokens ranked by the names holding them: value (4), set, get/parse...
    assert exp.subtoken_count == 2 + 3 and exp.node_count == 2 + len(
        {"A", "B", "C"} | {f"N{i}" for i in range(11)})
    ts = exp.term_subtokens
    assert ts.shape == (len(terms), 5) and (ts[0] == 0).all()
    value = 2  # the most common subtoken: the first id after PAD and UNK
    assert ts[terms.stoi["value"]].tolist() == [value, 0, 0, 0, 0]
    assert ts[terms.stoi["getValue"]][1] == value
    long_row = ts[terms.stoi["parseXMLFileAndSetValueSoonHere"]]
    assert (long_row > 0).all() and 1 in long_row.tolist()  # capped at 5; rare ones UNK
    assert exp.path_lengths.tolist() == [0, 3, 9, 1]
    assert (exp.path_nodes[2] >= 2).all()  # the first 9 of 11 nodes
    assert exp.path_nodes[1, 0] == exp.path_nodes[3, 0]  # "A" is one node
    lt = exp.label_targets
    assert exp.label_lengths.tolist() == [2, 2, 6]
    assert exp.target_names[:3] == ["<PAD>", "<UNK>", "<SOS>"]
    assert exp.target_names[lt[0, 1]] == "value" and lt[0, 1] == 3
    assert 1 in lt[2].tolist()  # beyond the target vocabulary: UNK


def test_sequence_subtoken_match_counts():
    names = ["<PAD>", "<UNK>", "<SOS>", "get", "value", "set"]
    expected = [("get", "value"), ("set", "value"), ("get",)]
    predicted = np.array([[3, 4, 0, 5], [3, 4, 1, 0], [5, 0, 0, 0]])
    acc, p, r, f1 = sequence_subtoken_match(expected, predicted, names)
    # row 0 whole: tp 2; row 1: get fp, value tp, set fn; row 2: set fp, get fn
    assert acc == pytest.approx(1 / 3)
    assert p == pytest.approx(3 / 5) and r == pytest.approx(3 / 5)
    assert f1 == pytest.approx(3 / 5)


# -- the normal path: the CLI, the loop, the refusals ------------------------


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory):
    from code2vec_tpu_torch.data.synth import SPECS, generate_corpus_files

    d = tmp_path_factory.mktemp("c2s")
    paths = generate_corpus_files(d, SPECS["tiny"])
    kinds = ["SimpleName", "NameExpr", "BlockStmt", "MethodCallExpr", "ReturnStmt", "IfStmt"]
    lines = []
    for line in open(paths["path_idx"], encoding="utf-8").read().splitlines():
        i = int(line.split("\t", 1)[0])
        if i == 0:
            lines.append(line)
            continue
        nodes = [kinds[(i * 7 + j * 3) % 6] for j in range(1 + i % 8)] + [f"Leaf{i}"]
        lines.append(f"{i}\t" + "↑".join(nodes[:2]) + "".join(f"↓{n}" for n in nodes[2:]))
    open(paths["path_idx"], "w", encoding="utf-8").write("\n".join(lines) + "\n")
    return paths


def cli_args(paths, out, *extra):
    return ["--model", "code2seq", "--device_epoch", "--device", "cpu",
            "--corpus_path", paths["corpus"], "--path_idx_path", paths["path_idx"],
            "--terminal_idx_path", paths["terminal_idx"], "--batch_size", "16",
            "--max_path_length", "20", "--seq_embed_size", "8", "--seq_rnn_size", "8",
            "--seq_decoder_size", "12", "--model_path", str(out), "--no_corpus_cache", *extra]


def epochs_of(capsys) -> list:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_cli_trains_evaluates_saves_and_resumes(corpus_files, tmp_path, capsys):
    from code2vec_tpu_torch import cli

    out = tmp_path / "model"
    assert cli.main(cli_args(corpus_files, out, "--max_epoch", "2",
                             "--checkpoint_cycle", "1")) == 0
    first = epochs_of(capsys)
    assert [e["epoch"] for e in first] == [0, 1]
    for e in first:
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["test_loss"])
        assert 0.0 <= e["f1"] <= 1.0 and e["train_steps"] > 0
    meta = json.loads((out / "model_meta.json").read_text())
    assert meta["model"] == "code2seq" and meta["decoder_size"] == 12
    assert (out / "checkpoint_last.pt").exists()
    assert cli.main(cli_args(corpus_files, out, "--max_epoch", "3", "--resume")) == 0
    assert [e["epoch"] for e in epochs_of(capsys)] == [2]


def test_the_loop_decays_the_rate_each_epoch(corpus_files):
    from code2vec_tpu_torch.data.reader import load_corpus
    from code2vec_tpu_torch.train import loop

    data = load_corpus(corpus_files["corpus"], corpus_files["path_idx"],
                       corpus_files["terminal_idx"], cache=False)
    seen = []
    real = loop.EpochRunner.run_train_epoch

    def spy(self, model, optimizer, *a):
        seen.append(optimizer.param_groups[0]["lr"])
        return real(self, model, optimizer, *a)

    config = TrainConfig(model="code2seq", device_epoch=True, batch_size=16, max_epoch=3,
                         max_path_length=20, seq_embed_size=8, seq_rnn_size=8,
                         seq_decoder_size=12, lr=0.1,
                         print_sample_cycle=0)
    loop.EpochRunner.run_train_epoch = spy
    try:
        result = loop.train(config, data, device="cpu", sinks=())
    finally:
        loop.EpochRunner.run_train_epoch = real
    assert seen == pytest.approx([0.1, 0.095, 0.09025])  # code2seq's x0.95 an epoch
    assert isinstance(result.model, Code2Seq) and result.epochs_run == 3


REFUSED = {
    "the host feed": dict(device_epoch=False),
    "kernel routes": dict(use_pallas=True),
    "lazy tables": dict(table_update="lazy"),
    "bf16 compute": dict(compute_dtype="bfloat16"),
    "meshes": dict(data_axis=2),
    "bucketed": dict(bucketed=True),
    "variable-name task": dict(infer_variable_name=True),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_what_code2seq_does_not_support_is_refused(what):
    config = TrainConfig(**{"model": "code2seq", "device_epoch": True, **REFUSED[what]})
    with pytest.raises(NotImplementedError, match=what):
        config.validate()


def test_serving_and_export_refuse_a_code2seq_model_dir(corpus_files, tmp_path, capsys):
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.predict import Predictor

    out = tmp_path / "model"
    assert cli.main(cli_args(corpus_files, out, "--max_epoch", "1")) == 0
    with pytest.raises(NotImplementedError, match="code2seq"):
        Predictor(str(out), corpus_files["terminal_idx"], corpus_files["path_idx"],
                  device="cpu")
    with pytest.raises(SystemExit, match="code2seq"):
        cli.main(cli_args(corpus_files, out, "--export_only"))


# -- the benchmark's side -----------------------------------------------------


def tiny_cell_config() -> dict:
    cfg = harness.load_json(harness.HERE / "configs" / "c2s_java_large.json")
    cfg.update(terminal_count=500, path_count=400, label_count=50, subtoken_vocab=60,
               node_vocab=20, target_vocab=40, embed_size=8, rnn_size=12, decoder_size=10,
               batch_size=16, max_path_length=20)
    cfg["corpus"].update(n_methods=300, median_contexts=12, max_contexts=60, signature_size=5)
    return cfg


def test_the_benchmark_reference_gives_the_tests_reference_loss():
    from c2vbench.code2seq_inputs import draw_tables, make_weights
    from c2vbench.corpus import draw_corpus
    from c2vbench.reference import sample_batch
    from c2vbench.reference_code2seq import sequence_loss

    cfg, seed, cpu = tiny_cell_config(), 2**31 + 5, torch.device("cpu")
    corpus = draw_corpus(cfg, seed, cpu)
    tables = draw_tables(cfg, seed, cpu)
    weights = make_weights(cfg, seed, cpu)
    batch = sample_batch(corpus, torch.arange(16), 20, torch.Generator().manual_seed(1))
    batch["example_mask"] = torch.ones(16)
    with torch.no_grad():
        got = sequence_loss(weights, tables, batch, batch["example_mask"])
        want = plain.loss(weights, tables, batch)
    torch.testing.assert_close(got, want, atol=0.0, rtol=LOSS_RTOL)
    lengths = tables["path_lengths"][1:]
    assert lengths.min() >= 3 and lengths.max() <= 9 and tables["path_lengths"][0] == 0
    assert (tables["label_lengths"] >= 1).all() and (tables["label_lengths"] <= 6).all()


def test_the_harness_finds_the_cell_and_its_metrics_read_nothing_untraced():
    from c2vbench.drivers import train_seq

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, "c2s_java_large.train_seq")
    assert cell.chips == 1 and cell.traffic["driver"] == "train_seq"
    names = {m["name"] for m in cell.per_layer}
    new = {"train.path_encoder_device_ms", "train.decoder_device_ms",
           "train.path_encoder_roofline_pct", "train.path_steps_useful_pct"}
    assert new | {"train.enqueue_ms", "train.mfu_pct", "train.device_idle_pct"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"train_contexts_per_s", "setup_s"}
    tiny = harness.Cell("tiny", 1, tiny_cell_config(), cell.traffic, [], [])
    run = train_seq.run(tiny, seed=2**31 + 99, seconds=0.3, trace=False,
                        device=torch.device("cpu"), t_start=time.perf_counter())
    assert run.correct and run.failed == 0 and run.attempted > 0, run.checks
    for name in new:
        assert harness.reader(name)(run) is None
    assert harness.reader("train_contexts_per_s")(run) > 0


def test_the_new_metrics_read_a_program_summary():
    summary = {"path_encoder": {"count": 10, "device_count": 10, "device_ms": 200.0,
                                "args": {"path_steps_real": 8.0e6, "path_steps_run": 2.0e7}},
               "decoder": {"count": 10, "device_count": 10, "device_ms": 50.0, "args": {}}}
    run = harness.Run(correct=True, attempted=10, failed=0, checks={},
                      counters={"program": summary, "path_step_flops": 262_144 + 1280})
    read = {m: harness.reader(m)(run) for m in (
        "train.path_encoder_device_ms", "train.decoder_device_ms",
        "train.path_encoder_roofline_pct", "train.path_steps_useful_pct")}
    assert read["train.path_encoder_device_ms"] == 20.0
    assert read["train.decoder_device_ms"] == 5.0
    assert read["train.path_steps_useful_pct"] == 40.0
    # 8e6 steps of 263,424 operations in 0.2 s at 67 TFLOP/s
    assert read["train.path_encoder_roofline_pct"] == pytest.approx(
        100 * 8.0e6 * 263_424 / (67e12 * 0.2))


def test_the_code2seq_yardstick_imports_nothing_of_the_port_or_jax():
    for name in ("reference_code2seq.py", "code2seq_inputs.py", "costs_code2seq.py"):
        for mod in guard.imported_names(guard.HERE / name):
            assert guard.top_level(mod) not in guard.YARDSTICK_FORBIDDEN, (name, mod)
    for mod in guard.imported_names(harness.ROOT / "tests" / "plain_code2seq.py"):
        assert guard.top_level(mod) not in guard.YARDSTICK_FORBIDDEN, mod


def test_code2seq_step_flops_by_hand():
    from c2vbench import costs_code2seq as c

    assert c.lstm_step_flops(128, 128) == 2 * 4 * 128 * 256 + 1280
    dims = dict(embed=2, rnn=4, decoder=3, nodes=2, name_parts=1, target_parts=0, targets=5)
    # B = L = 1: terminals 2*1*2; paths 2*2*(2*8*4 + 20); context 2*8*3 + 3;
    # one decoder step: lstm(5, 3) 2*12*8 + 30, q 18, scores 6 + 5, pool 6,
    # a 2*6*3, head 2*3*5 + 25
    want = 4 + 2 * 2 * (64 + 20) + 51 + (192 + 30 + 18 + 6 + 5 + 6 + 36 + 30 + 25)
    assert c.forward_flops(1, 1, **dims) == want
    assert c.train_step_flops(1, 1, **dims) == 3 * want
