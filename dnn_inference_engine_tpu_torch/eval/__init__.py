"""Evaluation: VOC mAP (voc.py, voc_dataset.py) and per-layer goldens
(golden.py), counterparts of the JAX package's ``eval/``."""
