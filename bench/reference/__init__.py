"""Plain PyTorch references of the benchmark's model families, one
module a family, frozen with the benchmark. They import neither the
port nor JAX and take nothing the program made: the harness draws the
weights and hands the same tensors to both sides."""
