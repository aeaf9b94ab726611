"""The SSD example (counterpart of ``examples/ssd/``): ``train``."""
