"""Hand-written CUDA kernels of the port, one module each, each with its
plain PyTorch version. Each module launches its C entries through
``_build.call``, which declares every entry once (``_build.ENTRIES``), and
counts its launches in a counter registered beside the wrapper
(``utils/counters.py`` ``counted``: ``<wrapper>.launches``)."""
