"""The benchmark's plain reference of Beat This!: the log-mel, the model's
forward and training step, the chunk rule and the minimal postprocessor in
plain PyTorch and NumPy.

It imports nothing of the program under test and takes nothing the program
made: the harness hands it the inputs it made itself (weights, audio,
batches). Every product can run in a lower precision (`quant.Quant`), which
is the comparison's control.
"""
