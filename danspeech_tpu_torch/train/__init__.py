"""Training stack of the port (``danspeech_tpu/train``).

Public surface:

- :mod:`.data`: manifest -> length-bucketed padded waveform batches
- :mod:`.step`: CTC train steps (spectrogram- and waveform-level)
- :mod:`.loop`: epoch loop + train / finetune / continue wrappers
- :mod:`.augment`: SpecAugment
- :mod:`.checkpoint`: train-state persistence
- ``python -m danspeech_tpu_torch.train``: the CLI (``__main__``)
"""

from .data import (  # noqa: F401
    Batch,
    SpeechDataset,
    batches,
    encode_transcript,
    load_manifest,
    shard_batch,
    steps_per_epoch,
)
from .loop import (  # noqa: F401
    GreedyEvaluator,
    continue_training,
    evaluate_greedy,
    export_model,
    finetune,
    train,
)
from .step import (  # noqa: F401
    TrainState,
    freeze_mask,
    init_train_state,
    make_optimizer,
    make_train_step,
    make_wave_train_step,
)
