"""CTC decoders. This slice carries the greedy decoder; beam search and LM
readers come with a later slice."""

from .greedy import (  # noqa: F401
    Decoder,
    GreedyDecoder,
    collapse_batch,
    collapse_sequence,
)
from .metrics import cer, levenshtein, wer  # noqa: F401
