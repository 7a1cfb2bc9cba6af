"""``Recognizer.recognize_batch`` of a pool entry on Mozilla DeepSpeech: the
engine's batch path over the MFCC, the dense layers and kernel B5 at H =
2048, the weights in the release's TensorFlow layout, the work counted from
the MFCC's frames and the comparison against the Mozilla reference
(``mozilla_serving.py``)."""

from mozilla_serving import MozillaServing


class Driver(MozillaServing):
    def call(self, waves):
        return self.rec.recognize_batch(waves)
