"""Configurations of the port, copies of the JAX package's ``repro.configs``:
the model configurations of the families the port serves, each of which
registers itself with :func:`repro_torch.models.registry.register`, and the
paper's stream testbed (``paper_stream``), which registers nothing."""
