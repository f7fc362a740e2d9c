"""Configuration loading (counterpart of ``dsopp_tpu/config``)."""
