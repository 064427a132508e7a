"""h100bench: the benchmark of kmer_tpu_torch on NVIDIA GPUs.

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix) for a fixed window and prints one JSON line; see README.md.
Nothing here imports jax or the JAX package: the port alone is measured.
"""
