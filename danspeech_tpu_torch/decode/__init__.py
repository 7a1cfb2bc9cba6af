"""CTC decoders and n-gram language models.

Greedy decoding (device argmax, host collapse); the LM-fused prefix beam
search on the host (``BeamCTCDecoder``: the C++ decoder of
``native/ctcbeam``, compiled at first use, with a Python oracle) and on the
device (``DeviceBeamDecoder`` over the hash tables of ``device_lm``);
``AutoBeamDecoder`` picks one of the two by batch size; ARPA and KenLM
binary (probing and trie) readers.
"""

from .beam import BeamCTCDecoder, prefix_beam_search  # noqa: F401
from .beam_auto import AutoBeamDecoder  # noqa: F401
from .device_beam import DeviceBeamDecoder  # noqa: F401
from .greedy import (  # noqa: F401
    Decoder,
    GreedyDecoder,
    collapse_batch,
    collapse_sequence,
)
from .kenlm_reader import KenLMProbingModel, load_kenlm_probing  # noqa: F401
from .lm import NgramLM, PackedNgramLM, load_arpa, load_lm  # noqa: F401
from .metrics import cer, levenshtein, wer  # noqa: F401
