"""The symbolic LSTM bucketing example (``lstm_bucketing.py``)."""
