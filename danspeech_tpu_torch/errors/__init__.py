"""Typed exceptions for danspeech_tpu_torch.

The same names as ``danspeech_tpu.errors`` (and the original danspeech
error surface), so code that catches them by name keeps working.
"""


class WaitTimeoutError(Exception):
    """Listening timed out while waiting for a phrase to start."""


class RequestError(Exception):
    pass


class UnknownValueError(Exception):
    pass


class ModelNotInitialized(Exception):
    """An LM/decoder was requested before an acoustic model was set."""


class WrongUsageOfListen(Exception):
    """A completed listen generator was advanced again."""


class NoDataInBuffer(Exception):
    """The background listener thread has produced no new audio yet."""


class ArgumentMissingForOption(Exception):
    pass


class ConvError(Exception):
    """Unsupported convolutional stack configuration (must be 1..3 layers)."""


class ModelDoesNotExistError(Exception):
    pass


class FreezingMoreLayersThanExist(Exception):
    """Tried to freeze more layers than the model has."""


class InvalidDataError(Exception):
    pass


class NotInCacheError(FileNotFoundError):
    """A zoo artifact was asked for with downloads off and is not in the
    cache (a port-only addition: ``utils/cache.get_model(download=False)``)."""
