"""Meshes, sharding trees and the collective record of a step
(``mesh``, ``shardings``, ``comm_stats``)."""
