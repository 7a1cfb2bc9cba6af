"""Reader for the zoo's ``.pth`` packages.

The port of ``danspeech_tpu/models/torch_pickle.py``. The JAX package
parses the two serialization formats itself to stay free of torch; here
torch is at hand, so :func:`torch_load` is ``torch.load`` with
``weights_only=True``, for both the zip format (torch >= 1.6) and the
legacy one. Its restricted unpickler resolves only containers
(``OrderedDict``, dicts, lists, tuples), plain values, dtypes,
``torch.Size`` and the tensor rebuilders, so loading a package executes no
code: a package that names any other global raises
``pickle.UnpicklingError``. ``weights_only=False`` is never passed.
"""

from __future__ import annotations

import io
from typing import Any

import torch


def torch_load(path) -> Any:
    """Load a ``.pth`` package (a path or its bytes) onto the CPU: tensors
    stay torch tensors, every other value is a plain Python object."""
    if isinstance(path, (bytes, bytearray)):
        path = io.BytesIO(bytes(path))
    return torch.load(path, map_location="cpu", weights_only=True)
