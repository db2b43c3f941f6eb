"""Plain references of the models the port runs, in PyTorch alone."""
