"""md5-validated download cache for model and LM artifacts.

A copy of ``danspeech_tpu/utils/cache.py`` with the same root: artifacts
live under ``~/.danspeech_tpu/{models,lms}/``, so a file that either
package fetched is found by the other. They are validated by md5 on every
load and downloaded again on a mismatch; a download that fails leaves no
partial file. Uses urllib. ``download=False`` (the port's addition) only
looks: a missing or invalid file raises ``errors.NotInCacheError`` and
nothing is fetched or created.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.request
import warnings

from ..errors import NotInCacheError

SUBDIR = {"acoustic_model": "models", "language_model": "lms"}


def default_cache_root() -> str:
    return os.path.join(os.path.expanduser("~"), ".danspeech_tpu")


def _hash_file(fpath: str, chunk_size: int = 65535) -> str:
    hasher = hashlib.md5()
    with open(fpath, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            hasher.update(chunk)
    return hasher.hexdigest()


def validate_file(fpath: str, file_hash: str, chunk_size: int = 65535) -> bool:
    """True iff ``fpath``'s md5 matches ``file_hash``."""
    return str(_hash_file(fpath, chunk_size)) == str(file_hash)


def get_model(
    model_name: str,
    origin: str,
    file_type: str = "acoustic_model",
    file_hash: str | None = None,
    cache_dir: str | None = None,
    download: bool = True,
) -> str:
    """Return a local path to ``model_name``, downloading from ``origin`` on miss.

    A cached file failing md5 validation is re-downloaded; a download that
    raises leaves no partial file behind. With ``download=False`` a miss
    raises :class:`NotInCacheError` instead.
    """
    if cache_dir is None:
        cache_dir = os.path.join(default_cache_root(), SUBDIR[file_type])
    fpath = os.path.join(cache_dir, model_name)
    if not download:
        if os.path.exists(fpath) and (not file_hash or validate_file(fpath, file_hash)):
            return fpath
        raise NotInCacheError(f"{model_name} is not in the cache {cache_dir} "
                              "and downloads are off")
    os.makedirs(cache_dir, exist_ok=True)

    download = True
    if os.path.exists(fpath):
        if file_hash and not validate_file(fpath, file_hash):
            print(
                f"A local file was found for {model_name}, but its md5 hash does not "
                f"match the expected value {file_hash}; re-downloading."
            )
        else:
            download = False

    if download:
        print(f"Downloading data from {origin}")
        try:
            with urllib.request.urlopen(origin) as resp, open(fpath, "wb") as out:
                shutil.copyfileobj(resp, out)
        except (Exception, KeyboardInterrupt):
            if os.path.exists(fpath):
                os.remove(fpath)
            raise
    return fpath


class NoDefaultCacheDirWarning(Warning):
    pass


def clean_cache() -> None:
    """Delete the entire on-disk artifact cache: ``~/.danspeech_tpu``, the
    root this package shares with ``danspeech_tpu``, so the JAX package's
    cached files go too."""
    cache_dir = default_cache_root()
    if os.path.isdir(cache_dir):
        shutil.rmtree(cache_dir)
    else:
        warnings.warn(
            "The default danspeech_tpu cache dir did not exist. If you are using a "
            "custom cache dir, delete it manually.",
            NoDefaultCacheDirWarning,
        )
