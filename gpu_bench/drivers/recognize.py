"""One ``Recognizer.recognize`` of a pool entry's single utterance: the
caller's batch size 1, the engine's batching bypassed."""

from serving import Serving


class Driver(Serving):
    def call(self, waves):
        return [self.rec.recognize(waves[0])]
