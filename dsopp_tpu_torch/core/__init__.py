"""Geometry and sampling primitives (counterpart of ``dsopp_tpu.core``)."""
