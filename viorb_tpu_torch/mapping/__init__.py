"""The map store and its checkpoints (port of viorb_tpu.mapping): numpy on
the host, as in the reference."""
