"""The device mesh: one process, several devices (port of kmer_tpu/dist)."""
