"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the card test is marked ``gpu``."""
