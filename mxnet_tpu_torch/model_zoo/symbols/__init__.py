"""Model symbols (copies of the examples, against the port's ``sym``)."""
