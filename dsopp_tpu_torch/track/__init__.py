"""Host-side track history (counterpart of ``dsopp_tpu.track``)."""
