"""The PyTorch twins of the JAX package's ``examples/``: each runs as
``python -m repro_torch.examples.<name>`` on the card by default (or with
``--device cpu``) and prints the reference example's headline lines."""
