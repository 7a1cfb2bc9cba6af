"""The port's docs (``docs/torch_api.md``, ``docs/torch_architecture.md``)
cite names that exist: every dotted ``danspeech_tpu_torch.`` name resolves
to a module or an attribute, every name a code block imports from the port
is there, every ``danspeech_tpu_torch/`` path is a file or directory of the
repo, and every stated divergence of ROADMAP §C is named."""

import ast
import importlib
import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ["docs/torch_api.md", "docs/torch_architecture.md"]
DOTTED = re.compile(r"\bdanspeech_tpu_torch(?:\.[A-Za-z_]\w*)+")
PATH = re.compile(r"\bdanspeech_tpu_torch/[\w/.]*\w")
BLOCK = re.compile(r"```python\n(.*?)```", re.S)
# the stated divergences of ROADMAP §C (C2, C3 and C15 are records, not API)
DIVERGENCES = ["C1", *[f"C{n}" for n in range(4, 15)], *[f"C{n}" for n in range(16, 22)]]


def _read(doc):
    with open(os.path.join(REPO, doc), encoding="utf-8") as f:
        return f.read()


def resolve(dotted):
    """Import the longest module prefix of ``dotted``, then walk the rest as
    attributes."""
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


@pytest.mark.parametrize("doc", DOCS)
def test_every_dotted_name_resolves(doc):
    names = sorted(set(DOTTED.findall(_read(doc))))
    assert len(names) >= 5
    for name in names:
        resolve(name)


@pytest.mark.parametrize("doc", DOCS)
def test_every_imported_name_exists(doc):
    blocks = BLOCK.findall(_read(doc))
    imported = 0
    for block in blocks:
        for node in ast.walk(ast.parse(block)):
            if isinstance(node, ast.ImportFrom) and node.module.startswith(
                    "danspeech_tpu_torch"):
                module = importlib.import_module(node.module)
                for alias in node.names:
                    assert hasattr(module, alias.name) or importlib.util.find_spec(
                        f"{node.module}.{alias.name}"), f"{node.module}.{alias.name}"
                    imported += 1
    assert imported or doc.endswith("architecture.md")


@pytest.mark.parametrize("doc", DOCS)
def test_every_path_exists(doc):
    for path in set(PATH.findall(_read(doc))):
        assert os.path.exists(os.path.join(REPO, path)), path


def test_every_divergence_is_named():
    text = "".join(_read(doc) for doc in DOCS)
    missing = [c for c in DIVERGENCES if not re.search(rf"\b{c}\b", text)]
    assert not missing, missing
