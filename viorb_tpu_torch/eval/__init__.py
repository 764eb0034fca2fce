"""Trajectory evaluation (port of viorb_tpu.eval)."""
