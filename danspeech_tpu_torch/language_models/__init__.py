"""Language-model zoo: Kneser-Ney n-gram LMs in KenLM ``.klm`` binary
format (the port of ``danspeech_tpu/language_models``).

Each constructor returns a local *path* to the ``.klm`` file
(md5-validated, in the shared cache of ``utils/cache.py``), which
``Recognizer(lm=...)`` and ``update_decoder(lm=...)`` accept. With
``download=False`` (the port's addition) a constructor only looks in the
cache and raises ``errors.NotInCacheError`` on a miss.
"""

from __future__ import annotations

from ..utils.cache import get_model

_RELEASE = "https://github.com/danspeech/danspeech/releases/download/v0.02-alpha"

_ZOO = {
    "DSL3gram": ("dsl_3gram.klm", "33ca3e2a8db3a036af6d7ad85972dbb0"),
    "DSL5gram": ("dsl_5gram.klm", "f2929d6d154b57b8be0c05347036c7e6"),
    "DSL3gramWithNames": ("dsl_names.klm", "1b47e2db841c6be5c62004ef51a40c68"),
    "DSLWiki3gram": ("dsl_wiki_3gram.klm", "f38f55a1e14ad888cee3ea1e643593dc"),
    "DSLWiki5gram": ("dsl_wiki_5gram.klm", "070287617eacbbde79df2be34ac9615f"),
    "DSLWikiLeipzig3gram": (
        "dsl_wiki_leipzig_3gram.klm",
        "8409a469be718209afdd18692a2d5609",
    ),
    "Wiki3gram": ("wiki_3gram.klm", "12877123bbbbaa72826746cad0af6f7d"),
    "Wiki5gram": ("wiki_5gram.klm", "b329e215b2fde5ffe3e2c94204f6c189"),
    "Folketinget3gram": (
        "da_lm_3gram_folketinget.klm",
        "011771d8bef6ff531812a768f631b4a2",
    ),
}


def _fetch(name: str, cache_dir=None, download: bool = True) -> str:
    filename, md5 = _ZOO[name]
    return get_model(
        model_name=filename,
        origin=f"{_RELEASE}/{filename}",
        file_hash=md5,
        cache_dir=cache_dir,
        file_type="language_model",
        download=download,
    )


def DSL3gram(cache_dir=None, download: bool = True) -> str:
    """DSL 3-gram LM — best performing along with DSL 5-gram."""
    return _fetch("DSL3gram", cache_dir, download)


def DSL5gram(cache_dir=None, download: bool = True) -> str:
    """DSL 5-gram LM (not pruned) — used for the published WER numbers."""
    return _fetch("DSL5gram", cache_dir, download)


def DSL3gramWithNames(cache_dir=None, download: bool = True) -> str:
    """DSL 3-gram LM augmented with Danish first names."""
    return _fetch("DSL3gramWithNames", cache_dir, download)


def DSLWiki3gram(cache_dir=None, download: bool = True) -> str:
    """DSL + Wikipedia 3-gram LM."""
    return _fetch("DSLWiki3gram", cache_dir, download)


def DSLWiki5gram(cache_dir=None, download: bool = True) -> str:
    """DSL + Wikipedia 5-gram LM."""
    return _fetch("DSLWiki5gram", cache_dir, download)


def DSLWikiLeipzig3gram(cache_dir=None, download: bool = True) -> str:
    """DSL + Wikipedia + Leipzig 3-gram LM."""
    return _fetch("DSLWikiLeipzig3gram", cache_dir, download)


def Wiki3gram(cache_dir=None, download: bool = True) -> str:
    """Wikipedia 3-gram LM."""
    return _fetch("Wiki3gram", cache_dir, download)


def Wiki5gram(cache_dir=None, download: bool = True) -> str:
    """Wikipedia 5-gram LM."""
    return _fetch("Wiki5gram", cache_dir, download)


def Folketinget3gram(cache_dir=None, download: bool = True) -> str:
    """Folketinget (parliament) 3-gram LM."""
    return _fetch("Folketinget3gram", cache_dir, download)


def CustomLanguageModel(path: str) -> str:
    """Identity wrapper for a local .klm/.arpa path."""
    return path
