"""Models of the port: the acoustic model (inference)."""
