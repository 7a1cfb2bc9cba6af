"""The drivers of a served model: the program's ``Recognizer`` built through
its package path from seeded weights, a pool of int16 waveforms from the
mix, and the comparison of sampled served transcripts with the plain
reference (``check.py``)."""

from __future__ import annotations

import gc
import time

import torch

import check
import mixes
import weights
from driver import Driver
from reference.deepspeech_ref import Model as Reference


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Serving(Driver):
    """Weights from the seed, BatchNorm statistics from a seeded calibration
    batch through the reference (timed as ``reference_s``), the program's
    recognizer loaded through ``DeepSpeechModel.load_model_package``, and
    the pool (``mixes.pool``). A pool entry is a list of waveforms; an
    output is a list of texts, one a waveform."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from danspeech_tpu_torch import Recognizer
        from danspeech_tpu_torch.models import DeepSpeechModel

        super().__init__(config, mix, seed, device)
        self.sd = weights.state_dict(config, seed, device)
        sync(device)
        t_ref = time.perf_counter()
        weights.calibrate(self.sd, config, seed, device)
        sync(device)
        self.reference_s = time.perf_counter() - t_ref
        model = DeepSpeechModel.load_model_package(weights.package(config, self.sd))
        self.rec = Recognizer(model=model, device=device, compute_dtype=config["compute_dtype"])
        self.pool = mixes.pool(mix, seed, device)

    def answered(self, entry, out) -> bool:
        return (out is not None and len(out) == len(entry)
                and all(isinstance(x, str) for x in out))

    def release(self) -> None:
        self.rec = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, records: list) -> list:
        """(call number, (pool index, row)) of ``check_requests`` answered
        requests drawn from the seed, the longest utterance among them."""
        answered = [(n, (c, r)) for n, (_, _, c, ok) in enumerate(records) if ok
                    for r in range(len(self.pool[c]))]
        lengths = {(c, r): len(w) for c, waves in enumerate(self.pool)
                   for r, w in enumerate(waves)}
        return check.sample_requests(answered, lengths, self.seed, self.mix["check_requests"])

    def gaps(self, requests: list, outputs: list, control: bool = False) -> dict:
        """{"text": widest gap of each request's served text against the
        reference, "control_text" with control: of the control's text
        instead, "control_frame": of the control's per-frame argmax}."""
        if not requests:
            return {"text": []}
        keys = sorted({key for _, key in requests})
        waves = [self.pool[c][r] for c, r in keys]
        logits = dict(zip(keys, (x.cpu().numpy() for x in Reference(self.sd, self.config)
                                 .logits(waves))))
        labels = self.config["labels"]
        blank = labels.index("_")
        out = {"text": [check.text_gap(logits[key], outputs[n][key[1]], labels, blank)
                        for n, key in requests]}
        if control:
            low = dict(zip(keys, (x.cpu().numpy() for x in
                                  Reference(self.sd, self.config, control=True).logits(waves))))
            out["control_text"] = [check.text_gap(logits[k], check.greedy_text(low[k], labels,
                                                                              blank),
                                                  labels, blank) for k in keys]
            out["control_frame"] = [check.frame_gap(logits[k], low[k].argmax(1)) for k in keys]
        return out

    def compare(self, records: list, outputs: list) -> dict:
        # no answered request at all reads as an infinite gap
        gaps = self.gaps(self.sample(records), outputs)["text"] or [float("inf")]
        return {"max_logit_gap": {"value": max(gaps),
                                  "limit": self.config["limits"]["max_logit_gap"]}}
