"""Kernels of the port (K2, K4, K5), their plain versions, and the NN pipeline."""
