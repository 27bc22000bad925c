"""Learned priors of the data-driven mode: the GMM pose prior and the
windowed linear AR motion model, and their training data."""
