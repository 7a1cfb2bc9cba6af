"""Parallelism on ``torch.distributed``: the port of
``danspeech_tpu/parallel``. A (data, model) mesh of ranks
(:mod:`.mesh`), parameter placement and the sharded optimizer
(:mod:`.sharding`), data-parallel transcription (:mod:`.batch`), the
time-sharded long-form forward (:mod:`.time_shard`), tensor parallelism
(:mod:`.tp`) and pipelined stages (:mod:`.pipeline`)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    data_sharding,
    initialize_multihost,
    make_mesh,
    replicated,
)
from .sharding import param_pspecs, param_shardings, shard_params  # noqa: F401
from .tp import pack_tp_params, tp_forward  # noqa: F401
from .batch import ShardedTranscriber  # noqa: F401
from .pipeline import PipelinedTranscriber, partition_layers  # noqa: F401
from .time_shard import (  # noqa: F401
    pad_time_for_mesh,
    time_sharded_forward,
    transcribe_long_form,
)
