"""``Recognizer.recognize_batch`` of a pool entry: the length buckets, group
merging and staging of the engine's batch path."""

from serving import Serving


class Driver(Serving):
    def call(self, waves):
        return self.rec.recognize_batch(waves)
