"""Seconds of set-up: the program's import, then from the card's CUDA
context (made by ``run.py`` before the program's first call) to the
window's first call: weights, calibration, the engine's plan, kernel
builds on a first run, and the warm-up of every pool batch. Left out, and
printed apart on standard error (``start-up s``): the import of numpy and
torch, the CUDA driver's start and the context, which no change to the
program shortens and which follow the host's file reads or stall for
seconds now and then."""


def read(ctx):
    return ctx["setup_s"]
