"""Logical-axis sharding policy (``repro_torch.sharding.policy``)."""
