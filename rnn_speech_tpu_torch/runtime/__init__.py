"""Host runtime of the port: the native C++ FLAC decoder and async loader
(``native/``, built at first use by ``native_build``, bound by
``audiodec`` and ``loader``), their ThreadSanitizer harness, and the
pure-Python FLAC decoder and encoder."""
