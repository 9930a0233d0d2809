"""JAX's ``--accelerator`` on the port's four CLIs that lacked it, on the CPU.

- the parsers of ``predict``, ``serve``, ``serve.fleet`` and
  ``tools/ann_build`` accept every option string JAX's counterpart
  accepts, compared flag set against flag set;
- a JAX command line with ``--accelerator`` parses and changes nothing:
  without the flag as with it, each entry point asks for the card (device
  ``None``: ``ops.backend.resolve_device`` gives ``cuda``), and
  ``--no_cuda`` / ``--device cpu`` still pick the CPU;
- the fleet puts ``--accelerator`` into each replica's command line, and
  that command line parses on the port's serve parser.
"""

import argparse

import pytest

from code2vec_tpu import predict as jax_predict
from code2vec_tpu.serve import __main__ as jax_serve
from code2vec_tpu.serve.fleet import __main__ as jax_fleet
from code2vec_tpu_torch import predict
from code2vec_tpu_torch.serve import __main__ as serve
from code2vec_tpu_torch.serve.fleet import __main__ as fleet
from code2vec_tpu_torch.tools import ann_build

REQUIRED = ["--model_path", "m", "--terminal_idx_path", "t", "--path_idx_path", "p"]


class _Parsed(Exception):
    def __init__(self, parser, namespace):
        super().__init__()
        self.parser, self.namespace = parser, namespace


def parser_of_main(main, argv, monkeypatch):
    """The parser (and parsed args) a ``main`` builds inline, caught at its
    ``parse_args`` before the entry point runs."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        raise _Parsed(self, real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as caught:
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return caught.value.parser, caught.value.namespace


def options(parser) -> set[str]:
    return {o for action in parser._actions for o in action.option_strings}


def load_jax_ann_build():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "ann_build.py"
    spec = importlib.util.spec_from_file_location("_jax_ann_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PREDICT_ARGV = ["File.java"] + REQUIRED


@pytest.mark.parametrize("cli", ["predict", "serve", "serve.fleet", "tools.ann_build"])
def test_every_jax_flag_is_in_the_ports_parser(cli, monkeypatch):
    if cli == "predict":
        want = options(parser_of_main(jax_predict.main, PREDICT_ARGV, monkeypatch)[0])
        got = options(parser_of_main(predict.main, PREDICT_ARGV, monkeypatch)[0])
    elif cli == "serve":
        want, got = options(jax_serve.build_parser()), options(serve.build_parser())
    elif cli == "serve.fleet":
        want, got = options(jax_fleet.build_parser()), options(fleet.build_parser())
    else:
        want = options(load_jax_ann_build().build_parser())
        got = options(ann_build.build_parser())
    assert "--accelerator" in want
    assert want - got == set()


@pytest.mark.parametrize("extra,device", [([], None), (["--accelerator"], None),
                                          (["--accelerator", "--no_cuda"], "cpu"),
                                          (["--no_cuda"], "cpu")])
def test_predict_runs_on_the_card_with_or_without_accelerator(extra, device, monkeypatch,
                                                              tmp_path):
    """``main`` hands the Predictor ``device=None`` (the card) unless
    ``--no_cuda``; ``--accelerator`` changes nothing."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_predictor(*a, device="unset", **kw):
        seen["device"] = device
        raise Stop

    monkeypatch.setattr(predict, "Predictor", fake_predictor)
    source = tmp_path / "A.java"
    source.write_text("class A {}")
    with pytest.raises(Stop):
        predict.main([str(source)] + REQUIRED + extra)
    assert seen["device"] == device


@pytest.mark.parametrize("extra,device", [([], None), (["--accelerator"], None),
                                          (["--accelerator", "--device", "cpu"], "cpu")])
def test_serve_and_ann_build_parse_accelerator_and_keep_the_card(extra, device):
    args = serve.build_parser().parse_args(REQUIRED + extra)
    assert args.device == device and args.accelerator == ("--accelerator" in extra)
    args = ann_build.build_parser().parse_args(["--code_vec", "c", "--out", "o"] + extra)
    assert args.device == device and args.accelerator == ("--accelerator" in extra)


@pytest.mark.parametrize("accelerator", [False, True])
def test_fleet_hands_accelerator_to_its_replicas(accelerator):
    argv = REQUIRED + (["--accelerator"] if accelerator else [])
    args = fleet.build_parser().parse_args(argv)
    worker = fleet.worker_argv(args, 0)
    assert ("--accelerator" in worker) == accelerator
    # the replica's command line parses on the port's serve parser, as JAX's
    # replicas parse JAX's
    start = worker.index("code2vec_tpu_torch.serve") + 1
    replica = serve.build_parser().parse_args(worker[start:])
    assert replica.accelerator == accelerator and replica.device is None
    jax_worker = jax_fleet.worker_argv(jax_fleet.build_parser().parse_args(argv), 0)
    assert ("--accelerator" in jax_worker) == accelerator
