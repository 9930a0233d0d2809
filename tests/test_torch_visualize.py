"""The port's projector export, its CLI's flags, and the plain pool's
batch-free form, on the CPU.

- ``write_projector_tsv`` and ``visualize_code_vectors`` write files byte
  for byte JAX's for the same ``code.vec``; ``python -m
  code2vec_tpu_torch.visualize`` writes them too;
- every option string of JAX's ``build_parser()`` exists in the port's
  parser;
  the reference's ``--gpu`` / ``--num_workers`` parse as no-ops, and
  non-default ``--rng_impl``, ``--pallas_block_b`` and
  ``--pallas_dma_depth`` raise;
- with gradients off the plain pool's card form
  (``batch_free_attention_pool``) agrees with its CPU form within 1e-6,
  and a row's bits do not depend on its batch or on zero padding.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from code2vec_tpu import cli as jax_cli
from code2vec_tpu import visualize as jax_visualize
from code2vec_tpu_torch import cli, visualize
from code2vec_tpu_torch.ops.attention import attention_pool, batch_free_attention_pool

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def code_vec(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "code.vec"
    labels = ["get|name", "set\tvalue", "to|string", "a|b|c"]  # a tab in a label
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(labels)}\t5\n")
        for label, vec in zip(labels, rng.standard_normal((len(labels), 5)).astype(np.float32)):
            f.write(label.replace("\t", "_") + "\t" + " ".join(str(float(e)) for e in vec) + "\n")
    return path


def read_dir(path: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir()) if p.suffix in (".tsv",
                                                                                 ".pbtxt")}


def test_projector_files_are_jaxs_bytes(code_vec, tmp_path):
    jax_visualize.write_projector_tsv(tmp_path / "jax", ["x\ty", "z\nw"], np.eye(2, 3))
    visualize.write_projector_tsv(tmp_path / "port", ["x\ty", "z\nw"], np.eye(2, 3))
    assert read_dir(tmp_path / "port") == read_dir(tmp_path / "jax")
    jax_visualize.visualize_code_vectors(code_vec, tmp_path / "jax2")
    paths = visualize.visualize_code_vectors(code_vec, tmp_path / "port2")
    want = read_dir(tmp_path / "jax2")
    assert read_dir(tmp_path / "port2") == want and len(want) == 3
    assert len(Path(paths["vectors"]).read_text().splitlines()) == 4


def test_visualize_module_runs(code_vec, tmp_path):
    proc = subprocess.run([sys.executable, "-m", "code2vec_tpu_torch.visualize", str(code_vec),
                           "--log_dir", str(tmp_path / "runs")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "runs" / "projector_config.pbtxt").exists()
    assert len((tmp_path / "runs" / "metadata.tsv").read_text().splitlines()) == 4


def options(parser) -> set[str]:
    return {o for action in parser._actions for o in action.option_strings}


# the flags of features the port has not yet: none since the autotuner
NOT_PORTED = set()


def test_every_jax_flag_is_in_the_ports_parser():
    missing = options(jax_cli.build_parser()) - options(cli.build_parser())
    assert missing == NOT_PORTED


def test_a_reference_command_line_parses():
    args = cli.build_parser().parse_args([
        "--corpus_path", "d/corpus.txt", "--gpu", "0", "--num_workers", "4",
        "--env", "floyd", "--find_hyperparams", "--num_trials", "3"])
    assert args.gpu == "0" and args.num_workers == 4 and args.find_hyperparams
    cli.config_from_args(args).validate()


@pytest.mark.parametrize("flag,value", [("--rng_impl", "rbg"), ("--pallas_block_b", "16"),
                                        ("--pallas_dma_depth", "3")])
def test_tpu_knobs_raise_off_their_default(flag, value):
    args = cli.build_parser().parse_args([flag, value])
    with pytest.raises(NotImplementedError, match=flag.lstrip("-")):
        cli.config_from_args(args).validate()
    with pytest.raises(NotImplementedError, match=flag.lstrip("-")):
        cli.main([flag, value, "--device", "cpu"])


def pool_inputs(seed, B, L, E):
    g = torch.Generator().manual_seed(seed)
    ctx = torch.tanh(torch.randn(B, L, E, generator=g))
    mask = (torch.rand(B, L, generator=g) < 0.7).float()
    mask[:, 0] = 1.0
    if B > 2:
        mask[1] = 0.0  # an all-masked row: uniform weights
    return ctx, mask, torch.randn(E, generator=g) * 0.3


@pytest.mark.parametrize("shape", [(1, 1, 7), (5, 37, 100), (8, 200, 100), (3, 513, 37)])
def test_batch_free_pool_agrees_with_the_cpu_form(shape):
    ctx, mask, attn = pool_inputs(1, *shape)
    with torch.no_grad():
        want_cv, want_w = attention_pool(ctx, mask, attn)
        got_cv, got_w = batch_free_attention_pool(ctx, mask, attn)
    torch.testing.assert_close(got_cv, want_cv, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_w, want_w, rtol=0, atol=1e-6)


def test_batch_free_pool_rows_do_not_move_with_the_batch_or_padding():
    ctx, mask, attn = pool_inputs(2, 9, 25, 100)
    with torch.no_grad():
        cv, _ = batch_free_attention_pool(ctx, mask, attn)
        for i in (0, 4, 8):
            alone, _ = batch_free_attention_pool(ctx[i:i + 1], mask[i:i + 1], attn)
            assert torch.equal(alone[0], cv[i])
        wide_ctx = torch.cat([ctx, torch.tanh(torch.randn(9, 175, 100))], 1)
        wide_mask = torch.cat([mask, torch.zeros(9, 175)], 1)
        wide, _ = batch_free_attention_pool(wide_ctx, wide_mask, attn)
    real = mask.sum(1) > 0
    assert torch.equal(wide[real], cv[real])


def test_bf16_batch_free_pool_rounds_as_the_cpu_form():
    ctx, mask, attn = pool_inputs(3, 4, 37, 16)
    with torch.no_grad():
        want, _ = attention_pool(ctx.bfloat16(), mask, attn.bfloat16())
        got, _ = batch_free_attention_pool(ctx.bfloat16(), mask, attn.bfloat16())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -7)
