"""The benchmark's plain reference: the paper's CNNs in plain PyTorch, float32,
with TF32 off, from the configuration file alone.

It imports nothing of the program under test (the `repro_torch` package),
nor `jax` or `repro`.  `logquant` is a frozen copy of the base-sqrt(2)
quantizer (NeuroMAX section 3), `cnn` walks a configuration's layer plan,
and `check` holds what the program produced against it.
"""
