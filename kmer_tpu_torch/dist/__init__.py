"""The device mesh, in one process or several (port of kmer_tpu/dist)."""
