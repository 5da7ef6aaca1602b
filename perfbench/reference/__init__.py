"""Plain PyTorch references of the benchmark's model families, in float32 with
TF32 off.  They import nothing of the program: they read the benchmark's
weights by the tree's keys and compute from the published equations."""
