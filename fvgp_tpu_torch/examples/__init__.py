"""The JAX package's nine worked examples on the port, one module each
under the same name.  Each runs on the card by default::

    python -m fvgp_tpu_torch.examples.single_task            # the card
    python -m fvgp_tpu_torch.examples.single_task --device cpu

``multichip_mesh`` is a ``torchrun`` script (``torchrun --nproc-per-node 4
-m fvgp_tpu_torch.examples.multichip_mesh``).  Every ``main(device=...)``
returns the example's key numbers as a dict, with ``"first"``: the LML and
posterior the model gives at its first hyperparameters, before any
training (the numbers that two devices or two packages must agree on)."""
