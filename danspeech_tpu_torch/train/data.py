"""Training data pipeline: manifest -> length-bucketed padded batches.

A copy of ``danspeech_tpu/train/data.py`` (numpy only), which consumes CSV
manifests of (wav path, transcript) rows:

- Batches carry PADDED WAVEFORMS + lengths, not spectrograms: the
  featurization runs on the device (ops/stft.py) inside the train step
  (train/step.py:make_wave_train_step), and SpecAugment follows it there.
- Utterances are sorted by duration once and cut into consecutive
  batches, and both the sample axis and the label axis pad to coarse
  buckets, so an epoch touches few distinct shapes and little padding.
- Batch membership is fixed by the sort; only batch ORDER shuffles per
  epoch (seeded, with numpy's generator, so both packages see the same
  batches). Epoch 0 runs in duration order when ``sortagrad`` is on (short
  utterances first stabilizes early CTC training).
- A trailing partial batch pads with zero-weight rows so every shape is
  full; the weights flow into the weighted CTC mean.
"""

from __future__ import annotations

import os
import wave as _wave
from typing import Iterator, NamedTuple

import numpy as np


def encode_transcript(text: str, labels: str) -> np.ndarray:
    """Transcript -> int32 label ids.

    Lowercases and drops characters outside the label set (the label set
    carries no casing or punctuation — reference labels.json); the blank
    symbol '_' never appears in text, so index 0 is reserved for CTC.
    """
    lut = {ch: i for i, ch in enumerate(labels)}
    ids = [lut[ch] for ch in text.lower() if ch in lut and ch != "_"]
    return np.asarray(ids, dtype=np.int32)


def decode_labels(ids, labels: str) -> str:
    return "".join(labels[i] for i in ids)


def load_manifest(path: str, root: str | None = None) -> list[tuple[str, str]]:
    """Parse a CSV manifest of ``wav_path,transcript`` lines.

    The transcript is everything after the FIRST comma (transcripts may
    contain commas; paths may not — the danspeech_training convention).
    Blank lines and ``#`` comments are skipped, as is an optional header
    row (``file,...`` / ``path,...`` / ``wav_filename,...``). Relative
    paths resolve against ``root`` (default: the manifest's directory).
    """
    if root is None:
        root = os.path.dirname(os.path.abspath(path))
    items: list[tuple[str, str]] = []
    saw_content = False  # header may follow comments/blank lines
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "," not in line:
                raise ValueError(
                    f"{path}:{lineno + 1}: expected 'wav_path,transcript'"
                )
            wav, transcript = line.split(",", 1)
            wav = wav.strip()
            first = not saw_content
            saw_content = True
            if first and wav.lower() in (
                "file", "path", "wav_filename", "wav_path", "filename",
            ):
                continue
            if not os.path.isabs(wav):
                wav = os.path.join(root, wav)
            items.append((wav, transcript.strip()))
    return items


def _wav_num_samples(path: str) -> int:
    """Frame count from the WAV header alone (no sample data read) —
    bucketing a large manifest must not load the corpus."""
    with _wave.open(path, "rb") as w:
        return w.getnframes()


class Utterance(NamedTuple):
    path: str
    transcript: str
    n_samples: int


class Batch(NamedTuple):
    """One padded training batch (host numpy)."""

    waves: np.ndarray          # (B, L) float32, zero-padded
    wave_lengths: np.ndarray   # (B,) int32 valid samples per row
    labels: np.ndarray         # (B, N) int32, zero-padded
    label_lengths: np.ndarray  # (B,) int32
    row_weights: np.ndarray    # (B,) float32 — 0.0 marks padding rows


class SpeechDataset:
    """Manifest-backed dataset: paths + transcripts + header-probed lengths.

    Waveforms load lazily at batch-assembly time (``load_wave``) so the
    working set is one batch, not the corpus.
    """

    # an utterance must hold at least one STFT frame; shorter (or empty)
    # files would reach the batched spectrogram with a length that makes
    # its dynamic reflect-pad index negative and poison the whole batch
    # with weight-1 garbage — reject at construction instead
    MIN_SAMPLES = 320  # n_fft at the 16 kHz / 20 ms window default

    def __init__(self, items: list[tuple[str, str]], labels: str):
        self.labels = labels
        self.utterances = [
            Utterance(p, t, _wav_num_samples(p)) for p, t in items
        ]
        self.encoded = [
            encode_transcript(u.transcript, labels) for u in self.utterances
        ]
        for u, enc in zip(self.utterances, self.encoded):
            if not len(enc):
                raise ValueError(
                    f"{u.path}: transcript encodes to zero labels: "
                    f"{u.transcript!r}"
                )
            if u.n_samples < self.MIN_SAMPLES:
                raise ValueError(
                    f"{u.path}: only {u.n_samples} samples — shorter than "
                    f"one {self.MIN_SAMPLES}-sample STFT frame"
                )

    @classmethod
    def from_manifest(
        cls, manifest_path: str, labels: str, root: str | None = None
    ) -> "SpeechDataset":
        return cls(load_manifest(manifest_path, root), labels)

    def __len__(self) -> int:
        return len(self.utterances)

    def load_wave(self, i: int) -> np.ndarray:
        from ..audio.io import load_audio_wavPCM

        return load_audio_wavPCM(self.utterances[i].path).astype(np.float32)


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def batches(
    dataset: SpeechDataset,
    batch_size: int,
    *,
    epoch: int = 0,
    seed: int | None = 0,
    sortagrad: bool = True,
    sample_bucket: int = 8000,
    label_bucket: int = 8,
    drop_last: bool = False,
) -> Iterator[Batch]:
    """Yield length-bucketed padded batches for one epoch.

    Membership: utterances sorted by duration, consecutive runs of
    ``batch_size``. Order: duration order on epoch 0 when ``sortagrad``,
    seeded shuffle of the BATCH order otherwise (per-epoch fold of the
    seed). The final short batch pads with zero-weight rows unless
    ``drop_last``.
    """
    order = sorted(
        range(len(dataset)), key=lambda i: dataset.utterances[i].n_samples
    )
    groups = [
        order[i : i + batch_size] for i in range(0, len(order), batch_size)
    ]
    if drop_last and groups and len(groups[-1]) < batch_size:
        groups.pop()
    if seed is not None and not (sortagrad and epoch == 0):
        np.random.default_rng((seed, epoch)).shuffle(groups)

    enc = dataset.encoded  # encoded once at dataset construction
    for group in groups:
        waves = [dataset.load_wave(i) for i in group]
        labels = [enc[i] for i in group]
        maxlen = _bucket(max(len(w) for w in waves), sample_bucket)
        maxlab = _bucket(max(len(l) for l in labels), label_bucket)
        b = len(group)
        batch = Batch(
            waves=np.zeros((batch_size, maxlen), np.float32),
            wave_lengths=np.zeros((batch_size,), np.int32),
            labels=np.zeros((batch_size, maxlab), np.int32),
            label_lengths=np.zeros((batch_size,), np.int32),
            row_weights=np.zeros((batch_size,), np.float32),
        )
        for r in range(b):
            batch.waves[r, : len(waves[r])] = waves[r]
            batch.wave_lengths[r] = len(waves[r])
            batch.labels[r, : len(labels[r])] = labels[r]
            batch.label_lengths[r] = len(labels[r])
            batch.row_weights[r] = 1.0
        # padding rows keep length 1 (a zero-length wave would make the
        # STFT's dynamic reflect-pad index negative); weight 0 removes
        # them from the loss
        for r in range(b, batch_size):
            batch.wave_lengths[r] = min(sample_bucket, maxlen)
            batch.label_lengths[r] = 1
        yield batch


def steps_per_epoch(
    n_utterances: int, batch_size: int, drop_last: bool = False
) -> int:
    if drop_last:
        return n_utterances // batch_size
    return (n_utterances + batch_size - 1) // batch_size


def shard_batch(batch: Batch, mesh=None) -> Batch:
    """This rank's rows of a batch: the ``mesh.index("data")``-th of
    ``n_data`` equal slices (the batch itself without a mesh). Row counts
    are always the full ``batch_size`` (padding rows weigh 0), so the one
    constraint is ``batch_size % n_data == 0``."""
    if mesh is None:
        return batch
    from ..parallel.mesh import DATA_AXIS

    n = mesh.size(DATA_AXIS)
    rows = len(batch.waves)
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split over {n} data ranks")
    per = rows // n
    lo = mesh.index(DATA_AXIS) * per
    return Batch(*(np.asarray(x)[lo : lo + per] for x in batch))
