"""The JAX package's 13 samples (``samples/``) on the port.

Each module keeps its sample's name, sizes and printout.  Its work is in
``main(device=None)``, which runs on the card unless told otherwise and
returns the numbers it prints as a dict; a sample whose reference draws
its input from ``jax.random`` takes that input as an argument too, so the
two packages can be held together on the same numbers.  Run one with::

    python -m eigenex_tpu_torch.samples.sample_lanczos1 [--device cpu]
"""

