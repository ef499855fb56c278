"""The benchmark's plain reference: the configurations' CNNs in plain
PyTorch, float32, with TF32 off, from the configuration file alone.

It imports nothing of the program under test (the `repro_torch` package),
nor `jax` or `repro`.  `logquant` is a frozen copy of the base-sqrt(2)
quantizer (NeuroMAX section 3), `families/<family>.py` holds each family's
layer plan, `cnn` finds a configuration's plan by its family and gives the
shared primitives, and `check` holds what the program produced against it.
"""
