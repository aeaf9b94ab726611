"""The Gluon word language model: ``model.py`` (``RNNModel``), ``train.py``
(the eager loop) and ``bench_lstm.py`` (the captured ``TrainStep``)."""
