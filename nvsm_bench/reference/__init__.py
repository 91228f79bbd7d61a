"""Plain PyTorch references that the cells are judged against.

Nothing here imports the program (``cunvsm_torch``), the JAX package or
JAX: each reference works its answer out again from the inputs that the
harness made from the seed.
"""
