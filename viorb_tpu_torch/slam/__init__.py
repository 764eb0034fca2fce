"""SLAM front end: projection matching and the device-resident tracking
step (port of viorb_tpu.slam)."""
