"""The plain reference: plain PyTorch, float32 with TF32 off, importing
nothing of the program."""
