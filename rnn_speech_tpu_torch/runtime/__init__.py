"""Host runtime of the port: the pure-Python FLAC decoder and encoder."""
