"""Sensors: camera providers, calibration, photometric correction (K18),
undistortion and masks (counterpart of ``dsopp_tpu/sensors``)."""
