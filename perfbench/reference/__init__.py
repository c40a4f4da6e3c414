"""The benchmark's plain reference: grid generation and the single-layer model's step
in plain NumPy and PyTorch, independent of the program under test (``grid``,
``fills``, ``ops``, ``model``)."""
