"""Core ANNS library of the port: the paper's modules in PyTorch."""
