"""Model configurations of the port, copies of the JAX package's
``repro.configs`` for the families the port serves; each module registers
itself with :func:`repro_torch.models.registry.register`."""
