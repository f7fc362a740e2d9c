"""Solvers (counterpart of ``dsopp_tpu.solvers``)."""
