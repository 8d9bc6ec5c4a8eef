"""The benchmark's plain reference: plain PyTorch in float32, importing
nothing of the program."""
