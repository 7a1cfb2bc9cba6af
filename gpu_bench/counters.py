"""Counters of the program that a launch check (``kernels/*.json``) reads
through the benchmark, where the program may lack them.

``step_launches`` is ``danspeech_tpu_torch.ops.lstm_cuda.lstm_step_launches``:
``lstm_step_kernel``'s launches, one a step walked. A program without that
counter reads 0: it has no served path that launches the step kernel (every
cell of such a program walks B5 persistently), so its traces hold no event
of it either.
"""

from __future__ import annotations


class _StepLaunches:
    @property
    def design_counts(self) -> dict:
        from danspeech_tpu_torch.ops import lstm_cuda

        own = getattr(lstm_cuda, "lstm_step_launches", None)
        return own.design_counts if own is not None else {"step": 0}


step_launches = _StepLaunches()
