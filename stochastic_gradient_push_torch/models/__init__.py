"""Models of the port: the dense transformer LM and the JAX-tree converter."""
