"""The Gluon examples (counterparts of ``examples/gluon/``): ``mnist``
and ``dcgan``."""
