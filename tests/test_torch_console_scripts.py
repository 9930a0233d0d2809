"""The port's console scripts (``pyproject.toml`` ``[project.scripts]``)
beside the JAX package's: each resolves to the port's ``main`` of its
module and answers ``--help`` as the installed script calls it
(``sys.exit(main())`` with ``sys.argv``), on the CPU."""

import importlib
import sys
import tomllib
from pathlib import Path

import pytest

SCRIPTS = tomllib.loads((Path(__file__).resolve().parent.parent / "pyproject.toml")
                        .read_text())["project"]["scripts"]
PORT = {
    "code2vec-tpu-torch": "code2vec_tpu_torch.cli:main",
    "code2vec-tpu-torch-extract": "code2vec_tpu_torch.extractor:main",
    "code2vec-tpu-torch-visualize": "code2vec_tpu_torch.visualize:main",
    "code2vec-tpu-torch-predict": "code2vec_tpu_torch.predict:main",
}


def test_the_jax_scripts_stay_as_they_were():
    assert {k: v for k, v in SCRIPTS.items() if not k.startswith("code2vec-tpu-torch")} == {
        "code2vec-tpu": "code2vec_tpu.cli:main",
        "code2vec-tpu-extract": "code2vec_tpu.extractor:main",
        "code2vec-tpu-visualize": "code2vec_tpu.visualize:main",
        "code2vec-tpu-predict": "code2vec_tpu.predict:main",
    }


@pytest.mark.parametrize("name", PORT)
def test_port_script_resolves_and_answers_help(name, monkeypatch, capsys):
    assert SCRIPTS[name] == PORT[name]
    module, attr = SCRIPTS[name].split(":")
    main = getattr(importlib.import_module(module), attr)
    assert callable(main) and main.__module__ == module
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as exit_info:
        sys.exit(main())
    assert exit_info.value.code == 0
    assert capsys.readouterr().out.startswith("usage:")
