"""``Recognizer.recognize_batch`` of a pool entry on an LSTM model: the
engine's batch path over kernel B5, the weights in ``nn.LSTM``'s layout,
the work counted for four gates and the comparison against the LSTM
reference (``lstm_serving.py``)."""

from lstm_serving import LSTMServing


class Driver(LSTMServing):
    def call(self, waves):
        return self.rec.recognize_batch(waves)
