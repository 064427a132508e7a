"""The plain reference: what each tool must print, worked out in plain
PyTorch and numpy from the benchmark's own generated inputs (the code
arrays the input files were written from), never from the program's
files or state.  It imports nothing of kmer_tpu_torch.

Keys are canonical 2-bit k-mer codes, min(forward, reverse complement),
counted by a sort; the program counts hash64 of them, a bijection, so
every count and histogram is the same.
"""
