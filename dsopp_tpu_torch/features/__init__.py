"""Image features (counterpart of ``dsopp_tpu.features``)."""
