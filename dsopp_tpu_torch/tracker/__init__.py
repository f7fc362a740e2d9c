"""The tracker (counterpart of ``dsopp_tpu.tracker``)."""
